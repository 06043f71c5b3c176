"""The benchmark's yardstick: the H100's peaks and the operations and
bytes that a model step, the ``partial_prefill`` kernel and the
``grouped_mm`` kernel need for given inputs.

Operations count the matrix products only, at 2 per multiply-add;
elementwise work (norms, rope, biases, softmax) is left out.  Bytes
count each input read once and each output written once, whatever a
kernel reads again.  Every count is of the rows that carry a real
position: padding rows add nothing, so no count depends on how the
program pads its batches.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: dense bf16 tensor rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def layer_flops_per_token(cfg: dict) -> int:
    """Matrix-product operations of one decoder layer for one token,
    without its attention over the context."""
    d, nh, nkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    proj = 2 * d * (nh * hd + 2 * nkv * hd) + 2 * nh * hd * d
    if cfg.get("num_experts"):
        E, k, f = (cfg["num_experts"], cfg["num_experts_per_tok"],
                   cfg["moe_intermediate_size"])
        ffn = 2 * d * E + k * 3 * 2 * d * f
    else:
        ffn = 3 * 2 * d * cfg["intermediate_size"]
    return proj + ffn


def attention_flops(cfg: dict, n_keys) -> int:
    """Q K^T and P V of one query row over ``n_keys`` keys, every head:
    ``n_keys`` may be an array (summed)."""
    nh, hd = cfg["num_attention_heads"], cfg["head_dim"]
    return int(4 * nh * hd * np.sum(np.asarray(n_keys, np.int64)))


def model_flops(cfg: dict, positions) -> int:
    """Useful operations of one forward over tokens at ``positions``
    (absolute, each attending to every earlier position and itself):
    every configured layer, its attention at that context, and the
    output head."""
    pos = np.asarray(positions, np.int64).reshape(-1)
    pos = pos[pos >= 0]
    L = cfg["num_hidden_layers"]
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    n = pos.size
    return (n * (L * layer_flops_per_token(cfg) + head)
            + L * attention_flops(cfg, pos + 1))


def partial_prefill_cost(q_shape, k_shape, q_pos, elem_bytes: int = 2):
    """(operations, bytes) one dense ``partial_prefill`` call needs.

    q (B, C, nh, hd), k and v (B, S, nkv, hd); ``q_pos`` (B, C), -1 for a
    padding row.  A slot's cache holds its stream from position 0, so the
    row at position p attends to the p + 1 keys 0..p, and the slot needs
    the keys up to its largest query position, K and V read once each.
    q is read and the output written whole (padding rows come out 0);
    the query positions and the needed key positions are int32."""
    B, C, nh, hd = q_shape
    nkv = k_shape[2]
    q_pos = np.asarray(q_pos, np.int64).reshape(B, C)
    valid = q_pos >= 0
    flops = int(4 * nh * hd * np.sum(np.where(valid, q_pos + 1, 0)))
    keys = np.where(valid.any(1), np.where(valid, q_pos, -1).max(1) + 1, 0)
    nbytes = (2 * B * C * nh * hd * elem_bytes
              + int(keys.sum()) * (2 * nkv * hd * elem_bytes + 4)
              + B * C * 4)
    return flops, nbytes


def grouped_mm_cost(m: int, k: int, n: int, ends, elem_bytes: int = 2):
    """(operations, bytes) one forward ``grouped_mm`` call needs: x (m, k)
    through w (E, k, n) by the running group ends ``ends`` (E,).  The
    rows up to ``ends[-1]`` are multiplied; each expert that has rows has
    its weights read once, an empty one none; every output row is
    written (rows past ``ends[-1]`` as zeros)."""
    ends = np.asarray(ends, np.int64).reshape(-1)
    rows = int(ends[-1]) if ends.size else 0
    sizes = np.diff(np.concatenate([[0], ends]))
    held = int(np.count_nonzero(sizes))
    flops = 2 * rows * k * n
    nbytes = (rows * k + held * k * n + m * n) * elem_bytes + 4 * ends.size
    return flops, nbytes


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the bf16 peak and the bytes at the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
