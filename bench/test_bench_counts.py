"""The yardstick's operation and byte counts on shapes worked by hand."""
import numpy as np
import pytest

import bench_counts as K

DENSE = dict(hidden_size=8, num_attention_heads=2, num_key_value_heads=1,
             head_dim=4, intermediate_size=16, vocab_size=10,
             num_hidden_layers=3)
MOE = dict(DENSE, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=6)


def test_layer_flops_by_hand():
    # q 8x8, k and v 8x4 each, o 8x8: 2 * (64 + 64 + 64) = 384;
    # SwiGLU 3 x 8x16: 2 * 384 = 768
    assert K.layer_flops_per_token(DENSE) == 384 + 768
    # router 8x4: 64; two experts of 3 x 8x6: 2 * 2 * 144 = 576
    assert K.layer_flops_per_token(MOE) == 384 + 64 + 576


def test_model_flops_by_hand_and_padding_free():
    pos = [0, 1, 2]
    # per token: 3 layers x 1152 + head 2 * 8 * 10; attention 3 layers x
    # 4 * 2 * 4 * (1 + 2 + 3) keys
    want = 3 * (3 * 1152 + 160) + 3 * 32 * 6
    assert K.model_flops(DENSE, pos) == want
    padded = np.array([[0, 1, -1, -1], [2, -1, -1, -1]])
    assert K.model_flops(DENSE, padded) == want
    assert K.model_flops(DENSE, [-1] * 64) == 0


def test_partial_prefill_verify_chunk_over_partly_filled_cache():
    # two slots, a 4-row chunk over a 64-position cache: slot 0 holds
    # positions 0..9 and feeds 10, 11 (two padding rows); slot 1 is idle
    q_pos = np.array([[10, 11, -1, -1], [-1, -1, -1, -1]])
    flops, nbytes = K.partial_prefill_cost((2, 4, 2, 4), (2, 64, 1, 4),
                                           q_pos, elem_bytes=2)
    assert flops == 4 * 2 * 4 * (11 + 12)
    q_and_out = 2 * (2 * 4 * 2 * 4) * 2
    kv = 12 * (2 * 1 * 4 * 2 + 4)      # 12 keys of K and V, and positions
    assert nbytes == q_and_out + kv + 2 * 4 * 4
    # more padding rows or idle slots add no operation
    wide = np.full((3, 8), -1)
    wide[0, :2] = [10, 11]
    assert K.partial_prefill_cost((3, 8, 2, 4), (3, 64, 1, 4),
                                  wide)[0] == flops


def test_grouped_mm_with_an_empty_group_and_a_tail_row():
    # 6 rows, groups of 2, 0 and 3 rows (expert 1 empty), one tail row
    flops, nbytes = K.grouped_mm_cost(6, 4, 3, [2, 2, 5], elem_bytes=2)
    assert flops == 2 * 5 * 4 * 3
    assert nbytes == (5 * 4 + 2 * 4 * 3 + 6 * 3) * 2 + 3 * 4
    # an empty call reads no weights
    assert K.grouped_mm_cost(0, 4, 3, [0, 0, 0]) == (0, 12)


def test_roofline_takes_the_larger_bound():
    assert K.roofline_seconds(K.PEAK_BF16_FLOPS, 0) == pytest.approx(1.0)
    assert K.roofline_seconds(0, K.HBM_BYTES_PER_S) == pytest.approx(1.0)
    assert K.roofline_seconds(K.PEAK_BF16_FLOPS, 2 * K.HBM_BYTES_PER_S) == \
        pytest.approx(2.0)
