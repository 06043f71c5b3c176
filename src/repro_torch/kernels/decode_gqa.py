"""GQA decode attention: one query token per slot over a dense KV cache.

Port of ``repro/kernels/decode_gqa/decode_gqa.py:decode_attention``.  The
CUDA kernel is ``csrc/decode_gqa.cu``; :func:`decode_attention_ref` is its
plain PyTorch version (the reference's ``ref.py`` with the kernel's
``l == 0 -> 1`` guard, so a query with no valid key gives 0).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (NEG_INF, build, check_kernel_inputs, on_cpu,
                                 raise_on_error, stream_ptr)

launches = 0   # kernel launches since the last reset (plain calls excluded)


def decode_attention_ref(q, k, v, q_pos, kv_pos, *, window: int = 0):
    """q: (B, nh, hd); k, v: (B, S, nkv, hd); q_pos: (B,); kv_pos: (B, S).
    Returns (B, nh, hd) in q's dtype; f32 softmax."""
    B, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qf = q.float().reshape(B, nkv, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) / math.sqrt(hd)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window:
        valid &= (q_pos[:, None] - kv_pos) < window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float()) / l
    return out.reshape(B, nh, hd).to(q.dtype)


def decode_attention(q, k, v, q_pos, kv_pos, *, window: int = 0):
    """Same contract as :func:`decode_attention_ref`; launches the CUDA
    kernel for CUDA tensors."""
    global launches
    if on_cpu(q, k, v, q_pos, kv_pos):
        return decode_attention_ref(q, k, v, q_pos, kv_pos, window=window)
    B, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, nkv, hd) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q_pos.shape != (B,) or kv_pos.shape != (B, S):
        raise ValueError("decode_attention: positions must be (B,), (B, S)")
    if nh % nkv:
        raise ValueError(f"decode_attention: nh {nh} % nkv {nkv} != 0")
    code = check_kernel_inputs("decode_attention", (q, k, v), (q_pos, kv_pos))
    out = torch.empty_like(q)
    fn = build.library("decode_gqa").decode_gqa_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), out.data_ptr(), B, S, nh, nkv, hd,
             int(window), code, stream_ptr(q))
    raise_on_error("decode_attention", err)
    launches += 1
    return out
