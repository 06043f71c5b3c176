"""Shared machinery of the block-table (paged) attention kernels.

Port of ``repro/kernels/paged.py``.  The paged ``decode_gqa`` and
``partial_prefill`` kernels read a slot's KV out of the shared block pool
through its block table (vLLM / PagedAttention layout).  This module owns
what both share:

* :func:`fused_layout` -- the reference's grid arithmetic, verbatim.  On
  the card ``block_kv`` no longer sets a DMA grouping (each CUDA block
  walks its range in its own tiles), but ``fused_layout`` still decides
  how many splits the table is cut into and where each split starts, so
  a given ``(block_kv, kv_splits)`` partitions the table exactly as the
  reference does.
* :func:`paged_partials` -- the plain PyTorch version of one split's
  online-softmax state ``(m, l, acc)``, over the pool through the table.
* :func:`combine_splits` -- the flash-decode merge of the split partials
  (plain version of the CUDA merge kernel in ``csrc/attn_common.cuh``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import NEG_INF


def fused_layout(max_bps: int, block_size: int, block_kv: int | None,
                 kv_splits: int = 1):
    """Resolve the fused/split layout of a paged kernel.

    Returns ``(fuse, splits, spb)``: table entries per reference grid
    step (``block_kv // block_size``, clamped to [1, max_bps];
    ``block_kv=None`` keeps one-block steps), parallel splits over the
    sequence (``kv_splits`` clamped so every split owns at least one
    fused step), and fused steps per split.  Split ``sp`` owns table
    entries ``[sp * spb * fuse, (sp + 1) * spb * fuse)``; entries past
    the table are masked.
    """
    fuse = 1 if block_kv is None else max(1, block_kv // block_size)
    fuse = min(fuse, max_bps)
    n_fused = -(-max_bps // fuse)
    splits = max(1, min(kv_splits, n_fused))
    spb = -(-n_fused // splits)
    return fuse, splits, spb


def paged_grid_info(max_bps: int, block_size: int, block_kv: int | None,
                    kv_splits: int = 1) -> dict:
    """Grid accounting: steps along the KV axis before and after fusion,
    and the resulting fused/split grid (the reference's bench fields)."""
    fuse, splits, spb = fused_layout(max_bps, block_size, block_kv,
                                     kv_splits)
    return dict(
        fuse=fuse,
        splits=splits,
        kv_steps=spb,
        kv_steps_total=splits * spb,
        kv_steps_unfused=max_bps,
        tokens_per_step=fuse * block_size,
    )


def combine_splits(m, l, acc, out_dtype):
    """Flash-decode reduction over the split axis (axis 1).

    ``m``/``l``: (N, splits, R) float32 partial max / normalizer; ``acc``:
    (N, splits, R, hd) float32 unnormalized accumulator.  An empty split
    carries (NEG_INF, 0, 0) and drops out; an all-empty row yields 0 (the
    ``l == 0`` guard).  At ``splits == 1`` this is bit-identical to
    finishing ``acc / l`` in place (``exp(m - m) = 1`` and the singleton
    sums are exact).
    """
    m_glob = m.amax(1)                                       # (N, R)
    w = torch.exp(m - m_glob[:, None])                       # (N, S, R)
    l_glob = (w * l).sum(1)                                  # (N, R)
    acc_glob = (w[..., None] * acc).sum(1)                   # (N, R, hd)
    l_glob = torch.where(l_glob == 0.0, 1.0, l_glob)
    return (acc_glob / l_glob[..., None]).to(out_dtype)


def paged_partials(q, k_pool, v_pool, q_pos, pos_pool, block_tables, *,
                   window: int = 0, block_kv: int | None = None,
                   kv_splits: int = 1):
    """Per-split online-softmax state of paged attention, plain PyTorch.

    q: (B, T, nh, hd); k_pool, v_pool: (nb, bs, nkv, hd); q_pos: (B, T)
    (-1 = padded row); pos_pool: (nb, bs) (-1 = invalid row);
    block_tables: (B, max_bps) (-1 = unmapped).  Masks: the row is
    mapped, ``kv_pos >= 0``, ``q_pos >= 0``, ``kv_pos <= q_pos`` and,
    with ``window``, ``q_pos - kv_pos < window``.

    Returns ``(m, l, acc)`` shaped (B * nh, splits, T) and (B * nh,
    splits, T, hd), float32, ready for :func:`combine_splits`.  Unmapped
    entries are never used as indices: they are clamped for the gather
    and masked (a negative index would wrap to the pool's last block).
    """
    B, T, nh, hd = q.shape
    bs, nkv = k_pool.shape[1], k_pool.shape[2]
    g = nh // nkv
    max_bps = block_tables.shape[1]
    fuse, splits, spb = fused_layout(max_bps, bs, block_kv, kv_splits)
    E = spb * fuse                                     # entries per split
    bt = block_tables.long()
    if splits * E > max_bps:                           # past the table
        bt = torch.cat([bt, bt.new_full((B, splits * E - max_bps), -1)], 1)
    mapped = bt >= 0
    btc = bt.clamp(min=0)
    K = E * bs
    k = k_pool[btc].float().reshape(B, splits, K, nkv, hd)
    v = v_pool[btc].float().reshape(B, splits, K, nkv, hd)
    kp = torch.where(mapped[..., None], pos_pool[btc].long(), -1)
    kp = kp.reshape(B, 1, splits, K)
    qp = q_pos.long()[:, :, None, None]                # (B, T, 1, 1)
    valid = (kp >= 0) & (qp >= 0) & (kp <= qp)         # (B, T, S, K)
    if window:
        valid &= (qp - kp) < window
    qf = q.float().reshape(B, T, nkv, g, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("btkgd,bsjkd->bkgtsj", qf, k)     # (B, nkv, g, T, S, K)
    vmask = valid[:, None, None]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(-1)                                     # NEG_INF when empty
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgtsj,bsjkd->bkgtsd", p, v)
    m = m.reshape(B * nh, T, splits).transpose(1, 2)
    l = l.reshape(B * nh, T, splits).transpose(1, 2)
    acc = acc.reshape(B * nh, T, splits, hd).transpose(1, 2)
    return m, l, acc


def paged_attention_ref(q, k_pool, v_pool, q_pos, pos_pool, block_tables,
                        *, window: int = 0, block_kv: int | None = None,
                        kv_splits: int = 1):
    """Plain paged attention: :func:`paged_partials` merged by
    :func:`combine_splits`.  q: (B, T, nh, hd) -> (B, T, nh, hd) in q's
    dtype; a row with no valid key (a padded query) gives 0."""
    B, T, nh, hd = q.shape
    m, l, acc = paged_partials(q, k_pool, v_pool, q_pos, pos_pool,
                               block_tables, window=window,
                               block_kv=block_kv, kv_splits=kv_splits)
    out = combine_splits(m, l, acc, q.dtype)           # (B * nh, T, hd)
    return out.reshape(B, nh, T, hd).transpose(1, 2)


def split_workspace(groups: int, splits: int, rows: int, hd: int, device):
    """f32 partials ``(m, l, acc)`` the CUDA kernels write when the layout
    has more than one split: (groups, splits, rows[, hd]), one group per
    (slot, kv head), ``rows`` query rows of that group.  None for a
    single split (the kernel finishes in place)."""
    if splits == 1:
        return None
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)
    return (empty(groups, splits, rows), empty(groups, splits, rows),
            empty(groups, splits, rows, hd))


def workspace_ptrs(ws) -> tuple[int, int, int]:
    return (0, 0, 0) if ws is None else tuple(t.data_ptr() for t in ws)


def check_paged_inputs(name: str, q, k_pool, v_pool, q_pos, pos_pool,
                       block_tables, q_pos_shape) -> None:
    """Shape checks a CUDA launch needs (the plain version indexes the
    same way and would fail on its own)."""
    nb, bs, nkv, hd = k_pool.shape
    B, nh = q.shape[0], q.shape[-2]
    if v_pool.shape != k_pool.shape or q.shape[-1] != hd:
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)} "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if pos_pool.shape != (nb, bs):
        raise ValueError(f"{name}: pos_pool must be ({nb}, {bs})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables must be ({B}, max_bps)")
    if tuple(q_pos.shape) != q_pos_shape:
        raise ValueError(f"{name}: q_pos must be {q_pos_shape}")
    if nh % nkv:
        raise ValueError(f"{name}: nh {nh} % nkv {nkv} != 0")
