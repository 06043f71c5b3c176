"""Attention with fused importance extraction (Synera section 3.2).

Port of ``repro/kernels/attn_importance/attn_importance.py:
attn_with_importance``.  The CUDA kernel is ``csrc/attn_importance.cu``;
:func:`attn_with_importance_ref` is its plain PyTorch version.  The
importance is the per-head column sum of the normalised softmax matrix
over the query rows.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (NEG_INF, build, check_kernel_inputs, on_cpu,
                                 raise_on_error, stream_ptr)

launches = 0   # kernel launches since the last reset (plain calls excluded)


def attn_with_importance_ref(q, k, v, q_pos, kv_pos, *, causal: bool = True):
    """q: (B, Tq, nh, hd); k, v: (B, S, nkv, hd); q_pos: (B, Tq); kv_pos:
    (B, S), -1 = padded query / invalid slot.  Returns (out (B, Tq, nh,
    hd) in q's dtype, importance (B, nh, S) f32)."""
    B, Tq, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qf = q.float().reshape(B, Tq, nkv, g, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) / math.sqrt(hd)
    kp, qp = kv_pos[:, None, :], q_pos[:, :, None]
    valid = (kp >= 0) & (qp >= 0)
    if causal:
        valid &= kp <= qp
    valid = valid[:, None, None]                       # (B, 1, 1, Tq, S)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    imp = p.sum(3).reshape(B, nh, -1)                  # column sums
    return out.reshape(B, Tq, nh, hd).to(q.dtype), imp


def attn_with_importance(q, k, v, q_pos, kv_pos, *, causal: bool = True):
    """Same contract as :func:`attn_with_importance_ref`; launches the
    CUDA kernel for CUDA tensors."""
    global launches
    if on_cpu(q, k, v, q_pos, kv_pos):
        return attn_with_importance_ref(q, k, v, q_pos, kv_pos, causal=causal)
    B, Tq, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, nkv, hd) or v.shape != k.shape:
        raise ValueError(f"attn_with_importance: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q_pos.shape != (B, Tq) or kv_pos.shape != (B, S):
        raise ValueError("attn_with_importance: positions must be (B, Tq), "
                         "(B, S)")
    if nh % nkv:
        raise ValueError(f"attn_with_importance: nh {nh} % nkv {nkv} != 0")
    code = check_kernel_inputs("attn_with_importance", (q, k, v),
                               (q_pos, kv_pos))
    out = torch.empty_like(q)
    imp = torch.empty((B, nh, S), dtype=torch.float32, device=q.device)
    fn = build.library("attn_importance").attn_importance_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), out.data_ptr(), imp.data_ptr(), B, Tq, S, nh,
             nkv, hd, int(causal), code, stream_ptr(q))
    raise_on_error("attn_with_importance", err)
    launches += 1
    return out, imp
