"""GQA decode attention: one query token per slot over the KV cache.

Port of ``repro/kernels/decode_gqa/decode_gqa.py``: ``decode_attention``
over a dense cache and ``decode_attention_paged`` over the shared block
pool through per-slot block tables.  Both CUDA kernels are one templated
tile loop in ``csrc/decode_gqa.cu``.  :func:`decode_attention_ref` is the
dense plain version (the reference's ``ref.py`` with the kernel's
``l == 0 -> 1`` guard, so a query with no valid key gives 0);
:func:`decode_attention_paged_ref` the paged one (per-split partials
merged by ``paged.combine_splits``, as the reference kernel does).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (NEG_INF, build, check_kernel_inputs, on_cpu,
                                 raise_on_error, stream_ptr)
from repro_torch.kernels import paged as PG
from repro_torch.kernels import splits as SP

# kernel launches since the last reset (plain calls excluded)
launches = 0          # decode_attention
paged_launches = 0    # decode_attention_paged


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
    kernel for CUDA tensors, cut into ``splits.dense_splits`` KV splits
    (f32 partials merged by a second kernel when there is more than
    one)."""
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
    SP.check_aligned("decode_attention", k, v)
    g = nh // nkv
    splits = SP.dense_splits(B, nkv, g, S, SP.sm_count(q.device))
    out = torch.empty_like(q)
    ws = PG.split_workspace(B * nkv, splits, g, hd, q.device)
    fn = build.library("decode_gqa").decode_gqa_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), out.data_ptr(), *PG.workspace_ptrs(ws), B, S,
             nh, nkv, hd, splits, int(window), code, stream_ptr(q))
    raise_on_error("decode_attention", err)
    launches += 1
    return out


def decode_attention_paged_ref(q, k_pool, v_pool, q_pos, pos_pool,
                               block_tables, *, window: int = 0,
                               block_kv: int | None = None,
                               kv_splits: int = 1):
    """q: (B, nh, hd); k_pool, v_pool: (nb, bs, nkv, hd); q_pos: (B,);
    pos_pool: (nb, bs), -1 = invalid row; block_tables: (B, max_bps), -1
    = unmapped.  Returns (B, nh, hd) in q's dtype."""
    out = PG.paged_attention_ref(q[:, None], k_pool, v_pool, q_pos[:, None],
                                 pos_pool, block_tables, window=window,
                                 block_kv=block_kv, kv_splits=kv_splits)
    return out[:, 0]


def decode_attention_paged(q, k_pool, v_pool, q_pos, pos_pool, block_tables,
                           *, window: int = 0, block_kv: int | None = None,
                           kv_splits: int = 1):
    """Same contract as :func:`decode_attention_paged_ref`; launches the
    CUDA kernel for CUDA tensors.  ``(block_kv, kv_splits)`` cut the table
    into the reference's split ranges (``paged.fused_layout``); with more
    than one split the kernel writes f32 partials and a second kernel
    merges them in split order."""
    global paged_launches
    args = (q, k_pool, v_pool, q_pos, pos_pool, block_tables)
    if on_cpu(*args):
        return decode_attention_paged_ref(*args, window=window,
                                          block_kv=block_kv,
                                          kv_splits=kv_splits)
    B, nh, hd = q.shape
    nb, bs, nkv, _ = k_pool.shape
    PG.check_paged_inputs("decode_attention_paged", *args, (B,))
    code = check_kernel_inputs("decode_attention_paged", (q, k_pool, v_pool),
                               (q_pos, pos_pool, block_tables))
    SP.check_aligned("decode_attention_paged", k_pool, v_pool)
    max_bps = block_tables.shape[1]
    fuse, splits, spb = PG.fused_layout(max_bps, bs, block_kv, kv_splits)
    out = torch.empty_like(q)
    ws = PG.split_workspace(B * nkv, splits, nh // nkv, hd, q.device)
    fn = build.library("decode_gqa").decode_gqa_paged_launch
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             q_pos.data_ptr(), pos_pool.data_ptr(), block_tables.data_ptr(),
             out.data_ptr(), *PG.workspace_ptrs(ws), B, nh, nkv, hd, bs,
             max_bps, splits, spb * fuse, int(window), code, stream_ptr(q))
    raise_on_error("decode_attention_paged", err)
    paged_launches += 1
    return out
