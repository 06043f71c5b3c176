"""Chunked (partial) prefill attention over a dense KV cache.

Port of ``repro/kernels/partial_prefill/partial_prefill.py:
partial_prefill_attention``.  The CUDA kernel is
``csrc/partial_prefill.cu``; :func:`partial_prefill_ref` is its plain
PyTorch version (the reference's ``ref.py``: padded query rows, q_pos =
-1, come out as 0).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (NEG_INF, build, check_kernel_inputs, on_cpu,
                                 raise_on_error, stream_ptr)

launches = 0   # kernel launches since the last reset (plain calls excluded)


def partial_prefill_ref(q, k, v, q_pos, kv_pos, *, window: int = 0):
    """q: (B, C, nh, hd); k, v: (B, S, nkv, hd); q_pos: (B, C); kv_pos:
    (B, S), -1 = invalid.  Returns (B, C, nh, hd) in q's dtype."""
    B, C, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qf = q.float().reshape(B, C, nkv, g, hd)
    s = torch.einsum("bckgd,bskd->bkgcs", qf, k.float()) / math.sqrt(hd)
    kp, qp = kv_pos[:, None, :], q_pos[:, :, None]
    valid = (kp >= 0) & (qp >= 0) & (kp <= qp)
    if window:
        valid &= (qp - kp) < window
    valid = valid[:, None, None]                       # (B, 1, 1, C, S)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgcs,bskd->bckgd", p, v.float()) / l.permute(
        0, 3, 1, 2, 4)
    return out.reshape(B, C, nh, hd).to(q.dtype)


def partial_prefill_attention(q, k, v, q_pos, kv_pos, *, window: int = 0):
    """Same contract as :func:`partial_prefill_ref`; launches the CUDA
    kernel for CUDA tensors."""
    global launches
    if on_cpu(q, k, v, q_pos, kv_pos):
        return partial_prefill_ref(q, k, v, q_pos, kv_pos, window=window)
    B, C, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, nkv, hd) or v.shape != k.shape:
        raise ValueError(f"partial_prefill_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q_pos.shape != (B, C) or kv_pos.shape != (B, S):
        raise ValueError("partial_prefill_attention: positions must be "
                         "(B, C), (B, S)")
    if nh % nkv:
        raise ValueError(f"partial_prefill_attention: nh {nh} % nkv {nkv}")
    code = check_kernel_inputs("partial_prefill_attention", (q, k, v),
                               (q_pos, kv_pos))
    out = torch.empty_like(q)
    fn = build.library("partial_prefill").partial_prefill_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), out.data_ptr(), B, C, S, nh, nkv, hd,
             int(window), code, stream_ptr(q))
    raise_on_error("partial_prefill_attention", err)
    launches += 1
    return out
