"""Chunked (partial) prefill attention over the KV cache.

Port of ``repro/kernels/partial_prefill/partial_prefill.py``:
``partial_prefill_attention`` over a dense cache and
``partial_prefill_attention_paged`` over the shared block pool through
per-slot block tables.  Both CUDA kernels are one templated tile loop in
``csrc/partial_prefill.cu``.  :func:`partial_prefill_ref` is the dense
plain version (the reference's ``ref.py``: padded query rows, q_pos = -1,
come out as 0); :func:`partial_prefill_paged_ref` the paged one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (NEG_INF, build, check_kernel_inputs, on_cpu,
                                 raise_on_error, stream_ptr)
from repro_torch.kernels import paged as PG
from repro_torch.kernels import splits as SP

# kernel launches since the last reset (plain calls excluded)
launches = 0          # partial_prefill_attention
paged_launches = 0    # partial_prefill_attention_paged


def partial_prefill_ref(q, k, v, q_pos, kv_pos, *, window: int = 0,
                        slots=None):
    """q: (B, C, nh, hd); k, v: (B, S, nkv, hd); q_pos: (B, C); kv_pos:
    (B, S), -1 = invalid.  With ``slots`` (B,) int32, k, v and kv_pos
    hold more slots (B', S, ...) and query slot b attends over cache row
    ``slots[b]``.  Returns (B, C, nh, hd) in q's dtype."""
    if slots is not None:
        k, v, kv_pos = k[slots], v[slots], kv_pos[slots]
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


def partial_prefill_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                              slots=None):
    """Same contract as :func:`partial_prefill_ref`; launches the CUDA
    kernel for CUDA tensors, cut into ``splits.dense_splits`` KV splits
    (f32 partials merged by a second kernel when there is more than
    one).  The kernel reads ``slots`` on the card: the cache is never
    gathered."""
    global launches
    if on_cpu(q, k, v, q_pos, kv_pos,
              *(() if slots is None else (slots,))):
        return partial_prefill_ref(q, k, v, q_pos, kv_pos, window=window,
                                   slots=slots)
    B, C, nh, hd = q.shape
    Bk, S, nkv = k.shape[0], k.shape[1], k.shape[2]
    if slots is None and Bk != B:
        raise ValueError(f"partial_prefill_attention: k/v hold {Bk} slots, "
                         f"q {B}, and no slot index is given")
    if slots is not None and (slots.shape != (B,)
                              or slots.dtype != torch.int32):
        raise ValueError(f"partial_prefill_attention: slots must be ({B},) "
                         f"int32, got {tuple(slots.shape)} {slots.dtype}")
    if k.shape != (Bk, S, nkv, hd) or v.shape != k.shape:
        raise ValueError(f"partial_prefill_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q_pos.shape != (B, C) or kv_pos.shape != (Bk, S):
        raise ValueError("partial_prefill_attention: positions must be "
                         "(B, C), (k's slots, S)")
    if nh % nkv:
        raise ValueError(f"partial_prefill_attention: nh {nh} % nkv {nkv}")
    code = check_kernel_inputs(
        "partial_prefill_attention", (q, k, v),
        (q_pos, kv_pos) + (() if slots is None else (slots,)))
    SP.check_aligned("partial_prefill_attention", q, k, v)
    rows = (nh // nkv) * C
    splits = SP.dense_splits(B, nkv, rows, S, SP.sm_count(q.device))
    out = torch.empty_like(q)
    ws = PG.split_workspace(B * nkv, splits, rows, hd, q.device)
    fn = build.library("partial_prefill").partial_prefill_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), None if slots is None else slots.data_ptr(),
             out.data_ptr(), *PG.workspace_ptrs(ws), B, C, S, nh, nkv, hd,
             splits, int(window), code, stream_ptr(q))
    raise_on_error("partial_prefill_attention", err)
    launches += 1
    return out


def partial_prefill_paged_ref(q, k_pool, v_pool, q_pos, pos_pool,
                              block_tables, *, window: int = 0,
                              block_kv: int | None = None,
                              kv_splits: int = 1):
    """q: (B, C, nh, hd); k_pool, v_pool: (nb, bs, nkv, hd); q_pos: (B,
    C), -1 = padded row; pos_pool: (nb, bs); block_tables: (B, max_bps),
    -1 = unmapped.  Returns (B, C, nh, hd) in q's dtype."""
    return PG.paged_attention_ref(q, k_pool, v_pool, q_pos, pos_pool,
                                  block_tables, window=window,
                                  block_kv=block_kv, kv_splits=kv_splits)


def partial_prefill_attention_paged(q, k_pool, v_pool, q_pos, pos_pool,
                                    block_tables, *, window: int = 0,
                                    block_kv: int | None = None,
                                    kv_splits: int = 1):
    """Same contract as :func:`partial_prefill_paged_ref`; launches the
    CUDA kernel for CUDA tensors (split partials merged by a second
    kernel when the layout has more than one split)."""
    global paged_launches
    args = (q, k_pool, v_pool, q_pos, pos_pool, block_tables)
    if on_cpu(*args):
        return partial_prefill_paged_ref(*args, window=window,
                                         block_kv=block_kv,
                                         kv_splits=kv_splits)
    B, C, nh, hd = q.shape
    nb, bs, nkv, _ = k_pool.shape
    PG.check_paged_inputs("partial_prefill_attention_paged", *args, (B, C))
    code = check_kernel_inputs("partial_prefill_attention_paged",
                               (q, k_pool, v_pool),
                               (q_pos, pos_pool, block_tables))
    SP.check_aligned("partial_prefill_attention_paged", q, k_pool, v_pool)
    max_bps = block_tables.shape[1]
    fuse, splits, spb = PG.fused_layout(max_bps, bs, block_kv, kv_splits)
    out = torch.empty_like(q)
    ws = PG.split_workspace(B * nkv, splits, (nh // nkv) * C, hd, q.device)
    fn = build.library("partial_prefill").partial_prefill_paged_launch
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             q_pos.data_ptr(), pos_pool.data_ptr(), block_tables.data_ptr(),
             out.data_ptr(), *PG.workspace_ptrs(ws), B, C, nh, nkv, hd, bs,
             max_bps, splits, spb * fuse, int(window), code, stream_ptr(q))
    raise_on_error("partial_prefill_attention_paged", err)
    paged_launches += 1
    return out
