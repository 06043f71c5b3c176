"""Weight quantization for the on-device SLM (Synera §6.8 / Table 6;
port of ``repro/optim/quantize.py``).

Symmetric per-output-channel fake quantization of matrix weights to
int8 / int4: quantize, then dequantize to the weight's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.tree import flatten, unflatten


def fake_quant(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-last-dim-channel quantize-dequantize.  ``torch.round``
    rounds half to even, as ``jnp.round``."""
    if w.dim() < 2:
        return w
    qmax = 2.0 ** (bits - 1) - 1
    wf = w.float()
    scale = torch.amax(torch.abs(wf), dim=-2, keepdim=True) / qmax
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax)
    return (q * scale).to(w.dtype)


_QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "in_proj", "out_proj", "unembed"}


def quantize_params(params: dict, bits: int = 8) -> dict:
    """Quantize every projection matrix of a parameter tree, picked by its
    leaf name; norms, embeddings and biases stay full precision, as
    AWQ / BnB leave them."""
    flat = flatten(params)
    return unflatten([p for p, _ in flat],
                     [fake_quant(leaf, bits)
                      if path[-1] in _QUANT_KEYS and leaf.dim() >= 2 else leaf
                      for path, leaf in flat])


def speedup_factor(bits: int) -> float:
    """Modeled device-side speedup from the weights' smaller bytes
    (memory-bound decode: time ~ weight bytes; the paper's Table 6
    measures 1.18x for BnB-4bit and 1.28x for AWQ end to end)."""
    return {8: 1.10, 4: 1.25}.get(bits, 1.0)
