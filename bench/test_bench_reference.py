"""The benchmark's plain reference against the program on the CPU, at
tiny widths of both families (the dense decoder with QKV bias, and the
MoE decoder), in float32: ``CloudEngine.prefill`` (the last row's full
logits, through the cache writes) and the verify feed over the cached
prefix (``CloudEngine.feed`` through the fused step) hold against the
reference's full forward over the stream.

Tolerance: 2e-4 absolute on logits of unit scale.  Both sides compute in
float32 but in other orders (the program's blocked or kernel attention
and grouped expert sums, the reference's per-stream softmax and
choice-order sums), so they differ by rounding alone: about 1e-6 after
two layers of width 64; 2e-4 leaves a hundredfold room and still fails a
wrong position, mask or weight, which moves logits by 1e-2 or more.
"""
import numpy as np
import pytest
import torch

import bench_harness as H
import bench_reference as R
import bench_tiny

ATOL = 2e-4


def _engine(name, seed=3):
    cfg = bench_tiny.config(name)
    pcfg = H.port_config(cfg, "float32")
    weights = H.draw_weights(pcfg, cfg, seed, "cpu")
    from repro_torch.serving.engine import CloudEngine
    eng = CloudEngine(pcfg, weights, max_slots=2, s_max=128, device="cpu")
    return cfg, weights, eng


def _feed(lens, starts, streams, width):
    tok = np.zeros((2, width), np.int32)
    pos = np.full((2, width), -1, np.int32)
    for b, (n, s) in enumerate(zip(lens, starts)):
        tok[b, :n] = streams[b][s:s + n]
        pos[b, :n] = np.arange(s, s + n)
    return tok, pos


@pytest.mark.parametrize("name", ["qwen1.5-7b", "qwen3-moe-8l"])
def test_prefill_and_verify_feed_match_reference(name):
    cfg, weights, eng = _engine(name)
    rng = np.random.default_rng(0)
    streams = [rng.integers(0, cfg["vocab_size"], 60) for _ in range(2)]
    prompt = [37, 20]
    # the prompt prefill: each slot's last row, with full logits
    tok, pos = _feed(prompt, [0, 0], streams, 40)
    last = eng.prefill(tok, pos)
    ref = R.logits_at(cfg, weights, [s[:37] for s in streams],
                      [[36], [19]])
    for b in range(2):
        np.testing.assert_allclose(last[b], ref[b][0].numpy(), atol=ATOL)
    # a verify feed over the cached prefix: 9 and 5 more tokens, read
    # through the fused step's last-row gather
    tok, pos = _feed([9, 5], prompt, streams, 32)
    last = eng.prefill(tok, pos)
    ref = R.logits_at(cfg, weights, [streams[0][:46], streams[1][:25]],
                      [list(range(37, 46)), list(range(20, 25))])
    np.testing.assert_allclose(last[0], ref[0][-1].numpy(), atol=ATOL)
    np.testing.assert_allclose(last[1], ref[1][-1].numpy(), atol=ATOL)
    # the same rows again through ``feed``: the verifier's argmax ids of
    # the selected rows (rewrites the same cache entries)
    sel = np.full((2, eng.verify_rows_max), -1, np.int32)
    sel[0, :5] = [4, 5, 6, 7, 8]
    sel[1, :5] = [0, 1, 2, 3, 4]
    rows = eng.feed(tok, pos, sel_idx=sel, need_dists=False)
    assert list(rows.token_id[0, :5]) == \
        ref[0][4:9].argmax(-1).tolist()
    assert list(rows.token_id[1, :5]) == ref[1].argmax(-1).tolist()


def test_reference_is_causal_and_per_stream():
    """A stream's logits do not depend on later tokens or on the other
    streams of the call."""
    cfg = bench_tiny.config("qwen1.5-7b")
    weights = H.draw_weights(H.port_config(cfg, "float32"), cfg, 4, "cpu")
    rng = np.random.default_rng(1)
    a = rng.integers(0, cfg["vocab_size"], 30)
    b = rng.integers(0, cfg["vocab_size"], 12)
    one = R.logits_at(cfg, weights, [a[:20]], [[5, 19]])[0]
    two = R.logits_at(cfg, weights, [b, a], [[3], [5, 19]])[1]
    torch.testing.assert_close(one, two, atol=ATOL, rtol=0)


def test_fp8_control_differs_from_f32():
    cfg = bench_tiny.config("qwen1.5-7b")
    weights = H.draw_weights(H.port_config(cfg, "float32"), cfg, 4, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg["vocab_size"], 40)
    f32 = R.logits_at(cfg, weights, [toks], [list(range(40))])[0]
    fp8 = R.logits_at(cfg, weights, [toks], [list(range(40))], "fp8")[0]
    err = float((f32 - fp8).abs().max())
    assert 1e-2 < err < 5.0, err
    with pytest.raises(ValueError):
        R.logits_at(cfg, weights, [toks], [[0]], "bf16")
