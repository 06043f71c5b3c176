"""Split-KV layout of the dense attention kernels.

The dense ``decode_attention`` and ``partial_prefill_attention`` kernels
(``csrc/decode_gqa.cu``, ``csrc/partial_prefill.cu``) run one block per
(slot, kv head, row tile, split).  Each block lists the 32-key tiles of
the cache that some of its query rows may see (the needed-tile walk) and
takes one of ``splits`` equal shares of that list; the shares' f32
partials are merged in split order by the merge kernel, whose plain
version is :func:`repro_torch.kernels.paged.combine_splits`.

This module owns the host side of that layout: the split count, chosen
from shapes alone (never from positions, which would need a device
sync), the launch grid, and :func:`dense_partials`, the plain PyTorch
version of the per-split partials, which cuts the same lists the same way.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import NEG_INF

SM_COUNT = 132        # H100 SXM; the wrappers ask the card
TILE_KEYS = 32        # keys per tile of the needed-tile walk
ROWS_PER_WARP = 16    # one m16n8k16 fragment of query rows
MAX_WARPS = 4         # partial prefill: at most 64 rows per block
MAX_SPLITS = 16
DECODE_THREADS = 128


def rows_per_block(rows: int) -> int:
    """Query rows of one partial-prefill block for a (slot, kv group) of
    ``rows = g * C`` rows: 16 per warp, one to four warps."""
    return ROWS_PER_WARP * min(MAX_WARPS, -(-rows // ROWS_PER_WARP))


def dense_splits(B: int, nkv: int, rows: int, S: int,
                 sms: int = SM_COUNT) -> int:
    """Split count of a dense launch, from shapes alone.  ``rows`` is g * C
    (g for decode).  Every split writes rows x hd f32 partials that a
    second kernel reads back, so the target grows with the partials'
    cost: up to one 16-row fragment of rows (decode, short chunks) the
    grid aims at two blocks per SM; wider chunks aim at one block per SM
    and so split only a grid smaller than the card.  At least two 32-key
    tiles of the cache per split, at most ``MAX_SPLITS``."""
    row_tiles = -(-rows // rows_per_block(rows))
    blocks = B * nkv * row_tiles
    target = (2 if rows <= ROWS_PER_WARP else 1) * sms
    want = -(-target // blocks)
    cap = max(1, min(MAX_SPLITS, -(-S // TILE_KEYS) // 2))
    return max(1, min(want, cap))


def dense_grid(B: int, nkv: int, rows: int, S: int, *, decode: bool,
               sms: int = SM_COUNT) -> dict:
    """The launch the dense wrappers make: split count, grid and threads
    per block."""
    splits = dense_splits(B, nkv, rows, S, sms)
    if decode:
        return dict(splits=splits, grid=(B * nkv, splits, 1),
                    threads=DECODE_THREADS)
    rb = rows_per_block(rows)
    return dict(splits=splits, grid=(B * nkv, -(-rows // rb), splits),
                threads=2 * rb)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def check_aligned(name: str, *tensors) -> None:
    """The kernels copy rows with 16-byte cp.async: every tensor they
    stage must start on a 16-byte boundary (rows of hd >= 16 elements then
    all do)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")


def dense_partials(q, k, v, q_pos, kv_pos, *, window: int = 0,
                   splits: int = 1):
    """Per-split online-softmax state of the dense kernels, plain PyTorch.

    q: (B, T, nh, hd) (T = 1 for decode); k, v: (B, S, nkv, hd); q_pos:
    (B, T), -1 = padded row or idle slot; kv_pos: (B, S), -1 = invalid.
    Row r of a (slot, kv head) group is token r // g, head r % g; rows
    are cut into :func:`rows_per_block` tiles.  For each row tile the
    needed 32-key tiles (a key some row of the tile may see) are listed
    in key order and split ``sp`` takes list entries ``[n sp // splits,
    n (sp + 1) // splits)``, as the kernels do.

    Returns ``(m, l, acc)`` shaped (B * nkv, splits, R) and (B * nkv,
    splits, R, hd), float32, R = g * T, ready for
    :func:`repro_torch.kernels.paged.combine_splits`.
    """
    B, T, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    R = g * T
    rb = rows_per_block(R)
    n_rt = -(-R // rb)
    n_tiles = -(-S // TILE_KEYS)
    qrow = q_pos.long().repeat_interleave(g, dim=1)          # (B, R)
    kp = kv_pos.long()                                       # (B, S)
    # owner[b, rt, s]: the split whose share holds key s for row tile rt
    owner = torch.full((B, n_rt, n_tiles * TILE_KEYS), -1, dtype=torch.long)
    for b in range(B):
        for rt in range(n_rt):
            qv = qrow[b, rt * rb:(rt + 1) * rb]
            qv = qv[qv >= 0]
            if qv.numel() == 0:
                continue
            qmin, qmax = int(qv.min()), int(qv.max())
            need = (kp[b] >= 0) & (kp[b] <= qmax)
            if window:
                need &= kp[b] > qmin - window
            need = torch.cat([need, need.new_zeros(n_tiles * TILE_KEYS - S)])
            tiles = need.reshape(n_tiles, TILE_KEYS).any(1).nonzero()[:, 0]
            n = tiles.numel()
            own = owner[b, rt].view(n_tiles, TILE_KEYS)
            for sp in range(splits):
                own[tiles[n * sp // splits:n * (sp + 1) // splits]] = sp
    owner = owner[:, :, :S].repeat_interleave(rb, dim=1)[:, :R]  # (B, R, S)

    valid = (kp[:, None, :] >= 0) & (qrow[:, :, None] >= 0) \
        & (kp[:, None, :] <= qrow[:, :, None])               # (B, R, S)
    if window:
        valid &= (qrow[:, :, None] - kp[:, None, :]) < window
    qf = q.float().reshape(B, T, nkv, g, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("btkgd,bskd->bktgs", qf, k.float()).reshape(
        B, nkv, R, S)
    vf = v.float()
    ms, ls, accs = [], [], []
    for sp in range(splits):
        vm = (valid & (owner == sp))[:, None]                # (B, 1, R, S)
        ssp = torch.where(vm, s, NEG_INF)
        m = ssp.amax(-1)                                     # NEG_INF if none
        p = torch.where(vm, torch.exp(ssp - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkrs,bskd->bkrd", p, vf))
    m = torch.stack(ms, 2).reshape(B * nkv, splits, R)
    l = torch.stack(ls, 2).reshape(B * nkv, splits, R)
    acc = torch.stack(accs, 2).reshape(B * nkv, splits, R, hd)
    return m, l, acc

