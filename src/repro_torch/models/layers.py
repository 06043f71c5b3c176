"""Neural building blocks of the dense decoder, of the MoE FFN and of the
Mamba2 (SSD) block (port of ``repro/models/layers.py``: the dense and moe
families with dense and paged KV caches, and the ssm family; the vlm and
audio families' non-causal attention -- cross-attention, the audio
encoder -- takes the plain paths below under every ``attn_impl``, as in
the reference).

Plain functions over explicit parameter dicts of tensors, as in the
reference.  Attention exists in three implementations, selected by
``cfg.attn_impl``:

  * ``naive``   -- materializes softmax(QK^T); the only XLA-path form
                   that can return the paper's importance score (column
                   sums of the attention matrix, Synera §3.2).
  * ``blocked`` -- online-softmax loop over KV blocks (flash pattern).
  * ``pallas``  -- the hand-written kernels in ``repro_torch/kernels``
                   (CUDA on the card, their plain versions on the CPU):
                   ``decode_gqa`` for T == 1 cached decode,
                   ``partial_prefill`` for chunked verification, and
                   ``attn_importance`` for the device draft path; over a
                   paged cache their block-table variants read the pool
                   in place.  The name is kept from the reference so one
                   ``ModelConfig`` drives both packages.  It also selects
                   the ``ssd_scan`` kernel for a multi-token Mamba2
                   forward (the reference's model path always takes the
                   XLA ``ssd_chunked`` there; its Pallas ``ssd_scan`` is
                   the same function, so the port puts its kernel there).

KV caches are updated in place (the reference donates them to jit).  A
paged per-layer cache is ``{"k"/"v": (nb, bs, nkv, hd), "pos": (nb, bs),
"block_tables": (B, max_bps)}``: one block table serves every layer
(the reference replicates it along the layer axis).  The reference's
block walkers are functional and route every -1 (padding, unmapped
entry, padded pair) to an out-of-bounds index that XLA drops or fills;
here -1 entries are filtered or masked explicitly (a negative torch
index would wrap to the last block), and every copy gathers its sources
before it writes, so a pair list whose destination is another pair's
source gives the reference's result.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.attn_importance import attn_with_importance
from repro_torch.kernels.decode_gqa import (decode_attention,
                                            decode_attention_paged)
from repro_torch.kernels.grouped_mm import grouped_mm
from repro_torch.kernels.partial_prefill import (
    partial_prefill_attention, partial_prefill_attention_paged)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.models import shardctx

NEG_INF = -1e30


def silu(x):
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def gated_rms_norm(y, z, w, eps: float = 1e-5):
    """Mamba2 gated RMSNorm: norm(y * silu(z)) * w."""
    return rms_norm(y * silu(z), w, eps)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def apply_rope(x, positions, theta: float):
    """x: (B, T, n_heads, head_dim); positions: (B, T) int."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    # a Python-scalar base: a tensor made from theta on the card would be
    # a host-to-device copy, and a host sync, in every call
    inv_freq = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * inv_freq          # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, kv_pos, window: int, causal: bool):
    """(B, Tq, S) additive bias; kv_pos < 0 marks invalid slots."""
    valid = kv_pos[:, None, :] >= 0
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        valid = valid & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, NEG_INF)


def naive_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                    causal: bool = True, return_importance: bool = False):
    """Materialized attention, grouped GQA (K/V never expanded).

    q: (B, Tq, nh, hd); k, v: (B, S, nkv, hd).
    Returns (out (B, Tq, nh, hd), importance (B, S) or None); importance
    is the column sum of the softmax matrix, averaged over heads and
    summed over query rows (Synera §3.2 / Fig 2).
    """
    B, Tq, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg = q.float().reshape(B, Tq, nkv, g, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * (1.0 / math.sqrt(hd))
    bias = _mask_bias(q_pos, kv_pos, window, causal)      # (B, Tq, S)
    s = s + bias[:, None, None, :, :]
    p = torch.softmax(s, dim=-1)                           # (B, nkv, g, Tq, S)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float()).reshape(
        B, Tq, nh, hd)
    imp = p.mean(dim=(1, 2)).sum(dim=1) if return_importance else None
    return out.to(q.dtype), imp


def blocked_attention(q, k, v, q_pos, kv_pos, *, block_kv: int = 1024,
                      window: int = 0, causal: bool = True):
    """Online-softmax attention over KV blocks (flash pattern)."""
    B, Tq, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    bk = min(block_kv, S)
    qf = q.float() * (1.0 / math.sqrt(hd))
    m = torch.full((B, nh, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nh, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nh, Tq, hd), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, bk):
        # the reference pads the tail block with kv_pos = -1 (masked);
        # a short tail block is the same computation
        kf = k[:, s0:s0 + bk].float().repeat_interleave(g, dim=2)
        vf = v[:, s0:s0 + bk].float().repeat_interleave(g, dim=2)
        s = torch.einsum("bthd,bshd->bhts", qf, kf)
        s = s + _mask_bias(q_pos, kv_pos[:, s0:s0 + bk], window,
                           causal)[:, None]
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhts,bshd->bhtd", p, vf)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).permute(0, 2, 1, 3).reshape(B, Tq, nh, hd)
    return out.to(q.dtype)


def pallas_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                     causal: bool = True, return_importance: bool = False,
                     slots=None):
    """Dispatch to the hand-written kernels (``cfg.attn_impl ==
    "pallas"``), exactly as the reference dispatches its Pallas kernels:

    * ``attn_importance``  -- importance fused into attention (device SLM
      draft path; windowed importance falls back to ``naive``)
    * ``decode_gqa``       -- T == 1 cached decode
    * ``partial_prefill``  -- chunked verification over a cached prefix

    None of them has a gradient (the reference's Pallas kernels have no
    ``custom_vjp``; a CUDA kernel's output here has no ``grad_fn``), so
    inputs that autograd would track are refused, on every device.

    ``slots`` (B,) int32: q holds B of the cache's slots, query slot b
    those of cache row ``slots[b]`` (see :func:`attention`).
    ``partial_prefill`` reads the index on the card; the other two
    kernels, which no slot-indexed forward calls, take the gathered rows.
    """
    refuse_grad("pallas_attention", q, k, v)
    if slots is not None and (return_importance or q.shape[1] == 1):
        k, v, kv_pos, slots = k[slots], v[slots], kv_pos[slots], None
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    if return_importance:
        if window:
            return naive_attention(q, k, v, q_pos, kv_pos, window=window,
                                   causal=causal, return_importance=True)
        out, imp = attn_with_importance(q, k, v, q_pos, kv_pos, causal=causal)
        # paper importance (§3.2): head mean of per-head column sums
        return out, imp.mean(dim=1)
    if q.shape[1] == 1:
        out = decode_attention(q[:, 0], k, v, q_pos[:, 0].contiguous(),
                               kv_pos, window=window)
        return out[:, None], None
    if slots is not None:
        slots = slots.to(torch.int32).contiguous()
    out = partial_prefill_attention(q, k, v, q_pos, kv_pos, window=window,
                                    slots=slots)
    return out, None


def _sharded_attention(q, k, v, q_pos, kv_pos, **kw):
    """:func:`attention` over DTensors, as a ``local_map`` region: each
    rank attends its own batch rows (q's batch sharding) with its own
    query heads (q's head sharding, kept where its shards hold whole GQA
    groups or share one KV head; else the heads are gathered) over the
    KV heads they read, K/V gathered over the other mesh dims (so the
    blocked scan never cuts a sharded sequence: the reference's
    ``constrain_batch_dim`` of K/V).  The plain paths run inside on
    local tensors.  (Left to DTensor, the einsums' flattened (batch,
    head) dims would gather every head onto every rank.)"""
    mesh = q.device_mesh
    nh = q.shape[2]
    g = nh // k.shape[2]
    bdims = [i for i, p in enumerate(q.placements) if p.is_shard(0)]
    hdims = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    ways = 1
    for i in hdims:
        ways *= mesh.shape[i]
    nh_loc = nh // ways
    if nh % ways or (nh_loc % g and g % nh_loc):
        hdims, nh_loc = [], nh
    qp = tuple(Shard(0) if i in bdims else Shard(2) if i in hdims
               else Replicate() for i in range(mesh.ndim))
    kp = tuple(Shard(0) if i in bdims else Replicate()
               for i in range(mesh.ndim))

    def region(ql, kl, vl, qpl, kvpl):
        h0 = shardctx.mesh_coord(mesh, hdims) * nh_loc
        kv0, kv1 = h0 // g, (h0 + nh_loc - 1) // g + 1
        # each head rank reads its own KV heads: K/V's gradient is the
        # sum over the head ranks
        haxes = [mesh.mesh_dim_names[i] for i in hdims]
        kl, vl = (shardctx.pvary(t, mesh, haxes) for t in (kl, vl))
        out, _ = attention(ql, kl[:, :, kv0:kv1], vl[:, :, kv0:kv1], qpl,
                           kvpl, **kw)
        return out

    out = local_map(region, out_placements=(qp,),
                    in_placements=(qp, kp, kp, kp, kp), device_mesh=mesh,
                    redistribute_inputs=True)(
        q, *(shardctx.as_dtensor(t, mesh) for t in (k, v, q_pos, kv_pos)))
    return out, None


def attention(q, k, v, q_pos, kv_pos, *, impl: str = "blocked",
              block_kv: int = 1024, window: int = 0, causal: bool = True,
              return_importance: bool = False, slots=None):
    """q (B, T, nh, hd) over k, v (B, S, nkv, hd) and kv_pos (B, S).  With
    ``slots`` (B,) int, k, v and kv_pos are a cache of more slots and
    query slot b attends over cache row ``slots[b]``: the hand-written
    kernel reads the index, the plain paths attend over the gathered
    rows."""
    if isinstance(q, DTensor):
        if return_importance:
            raise ValueError("importance over DTensors is not supported")
        if slots is not None:
            raise ValueError("a slot index over DTensors is not supported")
        return _sharded_attention(q, k, v, q_pos, kv_pos, impl=impl,
                                  block_kv=block_kv, window=window,
                                  causal=causal)
    if impl == "pallas" and causal:
        return pallas_attention(q, k, v, q_pos, kv_pos, window=window,
                                causal=causal,
                                return_importance=return_importance,
                                slots=slots)
    if slots is not None:
        k, v, kv_pos = k[slots], v[slots], kv_pos[slots]
    if return_importance or impl == "naive":
        return naive_attention(q, k, v, q_pos, kv_pos, window=window,
                               causal=causal,
                               return_importance=return_importance)
    out = blocked_attention(q, k, v, q_pos, kv_pos, block_kv=block_kv,
                            window=window, causal=causal)
    return out, None


# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------

def is_paged(cache) -> bool:
    """A paged per-layer cache carries a ``block_tables`` leaf."""
    return cache is not None and "block_tables" in cache


def cache_write_index(positions, s_max: int, slots=None):
    """Where ``cache_write`` puts each token: ``(b_idx, t_idx, row, slot)``
    for the non-negative positions only: new K/V (b_idx, t_idx) goes to
    cache row ``row`` -- ``slots[b_idx]`` when the forward runs over the
    cache rows ``slots``, else b_idx -- at ``slot``.  Negative positions
    mark padding and are dropped here -- the reference routes them to an
    out-of-bounds slot that XLA's scatter silently drops; torch indexing
    would raise instead.  Computed once per forward and shared by every
    layer (one host sync on CUDA).  ``meta`` positions (a shape-only
    trace) hold no padding to drop: every token is written.  For DTensor
    positions :func:`cache_write` computes each rank's index itself
    (None)."""
    if isinstance(positions, DTensor):
        return None
    if positions.is_meta:
        B, T = positions.shape
        b_idx = torch.arange(B, device="meta").repeat_interleave(T)
        t_idx = torch.arange(T, device="meta").repeat(B)
    else:
        b_idx, t_idx = (positions >= 0).nonzero(as_tuple=True)
    row = b_idx if slots is None else slots[b_idx].long()
    return b_idx, t_idx, row, positions[b_idx, t_idx].long() % s_max


def _cache_write_sharded(cache, k_new, v_new, positions):
    """:func:`cache_write` into a DTensor cache: each rank writes its own
    shard.  The new K/V and positions are laid out as the cache's batch
    dim (the rest gathered); a rank holding a slice of the sequence dim
    writes the tokens whose slots fall in it."""
    ck = cache["k"]
    mesh, pl = ck.device_mesh, ck.placements
    kn, vn, pos = [shardctx.as_dtensor(t, mesh).redistribute(
        mesh, tuple(p if p.is_shard(0) else Replicate() for p in pl)
    ).to_local() for t in (k_new, v_new, positions)]
    s_loc = ck.to_local().shape[1]
    shard_s = [i for i, p in enumerate(pl) if p.is_shard(1)]
    first = shardctx.mesh_coord(mesh, shard_s) * s_loc   # this rank's slots
    b_idx, t_idx, row, slot = cache_write_index(pos, ck.shape[1])
    if shard_s:
        # (a meta trace cannot select: each rank counts every token)
        if not pos.is_meta:
            own = (slot >= first) & (slot < first + s_loc)
            b_idx, t_idx, row, slot = (b_idx[own], t_idx[own], row[own],
                                       slot[own])
        slot = slot - first
    cache_write({k: v.to_local() for k, v in cache.items()}, kn, vn, pos,
                (b_idx, t_idx, row, slot))
    return cache


def cache_write(cache, k_new, v_new, positions, index=None):
    """Write new K/V in place at slots ``positions % s_max`` (circular
    when windowed).  Padding (position -1) never touches the cache.  A
    cache with a ``slots`` leaf is written at rows ``slots[b]`` (see
    :func:`cache_write_index`).  ``index`` is :func:`cache_write_index`
    for these positions, when the caller already has it.  Returns
    ``cache``."""
    if isinstance(cache["k"], DTensor):
        return _cache_write_sharded(cache, k_new, v_new, positions)
    if index is None:
        index = cache_write_index(positions, cache["k"].shape[1],
                                  cache.get("slots"))
    b_idx, t_idx, row, slot = index
    cache["k"][row, slot] = k_new[b_idx, t_idx].to(cache["k"].dtype)
    cache["v"][row, slot] = v_new[b_idx, t_idx].to(cache["v"].dtype)
    cache["pos"][row, slot] = positions[b_idx, t_idx].to(torch.int32)
    return cache


# -- paged (block-pool) cache: vLLM/PagedAttention layout -------------------

def _ids(x, device) -> torch.Tensor:
    """A block-id / row-count list as a long tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.long, device=device).reshape(-1)


def paged_write_index(positions, block_tables, block_size: int):
    """Where ``cache_write_paged`` puts each token: ``(b_idx, t_idx, blk,
    row)`` for tokens with a non-negative position whose table entry is
    mapped.  Token at position p of slot b lives at virtual slot ``v = p
    % s_max`` (circular when windowed, ``s_max = max_bps * bs``), i.e.
    pool block ``block_tables[b, v // bs]``, row ``v % bs``.  Padding and
    unmapped entries are dropped here (the reference routes them out of
    bounds, where XLA's scatter drops them).  Computed once per forward
    and shared by every layer."""
    s_max = block_tables.shape[1] * block_size
    pos = positions.long()
    vslot = torch.where(pos >= 0, pos % s_max, 0)
    entry = torch.gather(block_tables.long(), 1, vslot // block_size)
    b_idx, t_idx = ((pos >= 0) & (entry >= 0)).nonzero(as_tuple=True)
    return (b_idx, t_idx, entry[b_idx, t_idx],
            vslot[b_idx, t_idx] % block_size)


def cache_write_paged(cache, k_new, v_new, positions, index=None):
    """Scatter new K/V in place into the shared block pool through each
    slot's block table (see :func:`paged_write_index`).  Returns
    ``cache``."""
    if index is None:
        index = paged_write_index(positions, cache["block_tables"],
                                  cache["k"].shape[1])
    b_idx, t_idx, blk, row = index
    cache["k"][blk, row] = k_new[b_idx, t_idx].to(cache["k"].dtype)
    cache["v"][blk, row] = v_new[b_idx, t_idx].to(cache["v"].dtype)
    cache["pos"][blk, row] = positions[b_idx, t_idx].to(torch.int32)
    return cache


def cache_copy_blocks(stack, src, dst):
    """Copy pool blocks ``src[i] -> dst[i]`` in place within one paged kv
    stack (k/v/pos: (layers, nb, bs, ...)) -- the copy-on-write fork
    primitive.  ``src``/``dst`` are -1-padded; a pair with ``dst < 0`` is
    dropped.  Every source is gathered before any destination is written,
    as in the reference's functional copy."""
    nb = stack["k"].shape[1]
    dev = stack["k"].device
    s, d = _ids(src, dev), _ids(dst, dev)
    keep = d >= 0
    s, d = s[keep].clamp(0, nb - 1), d[keep]
    if d.numel() == 0:
        return stack
    vals = {key: stack[key][:, s] for key in ("k", "v", "pos")}
    for key, val in vals.items():
        stack[key][:, d] = val
    return stack


def cache_copy_block_rows(stack, src, dst, rows):
    """Partial-block tail copy in place within one paged kv stack: for
    each pair, clone the first ``rows[i]`` token rows of pool block
    ``src[i]`` into block ``dst[i]`` (k/v/pos together), leaving dst's
    other rows untouched.  ``src``/``dst`` -1-padded, ``rows`` 0 for
    padding; padded or empty pairs are dropped.  Sources and the
    destinations' old rows are gathered before anything is written."""
    nb, bs = stack["k"].shape[1], stack["k"].shape[2]
    dev = stack["k"].device
    s, d, n = _ids(src, dev), _ids(dst, dev), _ids(rows, dev)
    keep = (d >= 0) & (n > 0)
    s, d, n = s[keep].clamp(0, nb - 1), d[keep], n[keep]
    if d.numel() == 0:
        return stack
    mask = torch.arange(bs, device=dev)[None, :] < n[:, None]   # (m, bs)
    vals = {}
    for key in ("k", "v", "pos"):
        src_c, dst_c = stack[key][:, s], stack[key][:, d]
        m = mask.reshape((1,) + mask.shape + (1,) * (src_c.dim() - 3))
        vals[key] = torch.where(m, src_c, dst_c)
    for key, val in vals.items():
        stack[key][:, d] = val
    return stack


def cache_peek_blocks(stack, blocks):
    """Read-only gather of pool blocks ``blocks[i]`` (k/v/pos, each
    (layers, m, bs, ...)) from one paged kv stack: a copy, never a view,
    since the pool is written afterwards.  -1 entries gather a clamped
    block the caller ignores."""
    nb = stack["k"].shape[1]
    b = _ids(blocks, stack["k"].device).clamp(0, nb - 1)
    return {key: stack[key][:, b] for key in ("k", "v", "pos")}


def cache_gather_blocks(stack, blocks):
    """Swap-out primitive: gather pool blocks ``blocks[i]`` (a copy) and
    invalidate their pool positions in place, so a swapped-out block
    never reads as valid through a future owner's table.  -1 entries
    gather junk and invalidate nothing.  Returns ``(payload, stack)``."""
    payload = cache_peek_blocks(stack, blocks)
    b = _ids(blocks, stack["k"].device)
    stack["pos"][:, b[b >= 0]] = -1
    return payload, stack


def cache_scatter_blocks(stack, blocks, payload):
    """Swap-in primitive: write a gathered payload back into pool blocks
    ``blocks[i]`` in place (k/v/pos together, bit-identical to what was
    gathered).  Pairs with ``blocks[i] < 0`` are dropped."""
    dev = stack["k"].device
    b = _ids(blocks, dev)
    keep = b >= 0
    for key in ("k", "v", "pos"):
        val = payload[key].to(device=dev, dtype=stack[key].dtype)
        stack[key][:, b[keep]] = val[:, keep]
    return stack


def paged_kv_view(cache):
    """Gather a slot-major (B, s_max, ...) view of the paged pool -- the
    read path of the ``naive``/``blocked`` attention.  Unmapped table
    entries read as K/V = 0, pos = -1 (masked), so the view is
    element-wise identical to the dense cache after the same writes."""
    bt = cache["block_tables"].long()                # (B, max_bps)
    mapped = bt >= 0
    btc = bt.clamp(min=0)
    k = torch.where(mapped[..., None, None, None], cache["k"][btc], 0)
    v = torch.where(mapped[..., None, None, None], cache["v"][btc], 0)
    pos = torch.where(mapped[..., None], cache["pos"][btc], -1)
    B, mb, bs = pos.shape
    return (k.reshape(B, mb * bs, *k.shape[3:]),
            v.reshape(B, mb * bs, *v.shape[3:]),
            pos.reshape(B, mb * bs))


def paged_pallas_attention(q, cache, q_pos, *, window: int = 0,
                           block_kv: int | None = None, kv_splits: int = 1):
    """Dispatch the block-table kernels over the pool in place (no
    gathered copy): ``decode_attention_paged`` for T == 1,
    ``partial_prefill_attention_paged`` for any other T.  ``block_kv``
    and ``kv_splits`` cut the table into the reference's split ranges.
    Like :func:`pallas_attention`, it refuses inputs under grad."""
    refuse_grad("paged_pallas_attention", q, cache["k"], cache["v"])
    q = q.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    args = (cache["k"], cache["v"])
    pos, bt = cache["pos"], cache["block_tables"]
    if q.shape[1] == 1:
        out = decode_attention_paged(q[:, 0], *args, q_pos[:, 0].contiguous(),
                                     pos, bt, window=window,
                                     block_kv=block_kv, kv_splits=kv_splits)
        return out[:, None]
    return partial_prefill_attention_paged(q, *args, q_pos, pos, bt,
                                           window=window, block_kv=block_kv,
                                           kv_splits=kv_splits)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache + core)
# ---------------------------------------------------------------------------

def attn_block(p, x, positions, cfg, cache=None, *, kv_pos=None, causal=True,
               rope=True, window=0, return_importance=False, n_heads=None,
               n_kv=None, write_index=None):
    """Self-attention with optional cache.

    x: (B, T, d).  If ``cache`` is given, new K/V are written into it (in
    place) and attention runs over the whole buffer (a paged cache
    through its block table; a dense cache with a ``slots`` leaf at rows
    ``slots[b]``).  ``write_index`` is the cache's write index
    for ``positions`` (:func:`cache_write_index` or
    :func:`paged_write_index`), when the caller already has it.
    Returns (out, cache, importance).
    """
    nh = n_heads if n_heads is not None else cfg.n_heads
    nkv = n_kv if n_kv is not None else cfg.n_kv_heads
    hd = cfg.head_dim

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = shardctx.split_dim(q, -1, (nh, hd))
    k = shardctx.split_dim(k, -1, (nkv, hd))
    v = shardctx.split_dim(v, -1, (nkv, hd))

    src_pos = positions if kv_pos is None else kv_pos
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, src_pos, cfg.rope_theta)

    if is_paged(cache):
        cache_write_paged(cache, k, v, positions, write_index)
        if cfg.attn_impl == "pallas" and causal and not return_importance:
            # block-table kernels read the pool in place: the gathered
            # (B, s_max) view is never materialized
            out = paged_pallas_attention(
                q, cache, positions, window=window,
                block_kv=getattr(cfg, "paged_block_kv", None),
                kv_splits=getattr(cfg, "paged_kv_splits", 1))
            out = shardctx.merge_heads(out) @ p["wo"]
            return row_parallel_out(out), cache, None
        k_all, v_all, kv_positions = paged_kv_view(cache)
    elif cache is not None:
        cache_write(cache, k, v, positions, write_index)
        k_all, v_all, kv_positions = cache["k"], cache["v"], cache["pos"]
    else:
        k_all, v_all, kv_positions = k, v, src_pos

    out, imp = attention(
        q, k_all, v_all, positions, kv_positions,
        impl=cfg.attn_impl, block_kv=cfg.attn_block_kv, window=window,
        causal=causal, return_importance=return_importance,
        slots=None if cache is None else cache.get("slots"))
    out = shardctx.merge_heads(out) @ p["wo"]
    return row_parallel_out(out), cache, imp


# ---------------------------------------------------------------------------
# FFN: dense SwiGLU and MoE
# ---------------------------------------------------------------------------

def row_parallel_out(x):
    """A row-parallel product's output as it joins the residual stream:
    on a mesh, reduced and laid out over the batch axes (left partial,
    every later product would run replicated over "model")."""
    return shardctx.constrain_batch_dim(x, 0)


def mlp(p, x):
    return row_parallel_out(
        (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"])


def moe_route(router, xf, top_k: int):
    """Token-choice routing: f32 router logits, softmax, top-k, the top-k
    weights renormalised.  Returns (probs (N, E), top_p (N, k), top_e (N,
    k)), experts in descending probability as ``lax.top_k`` gives them."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    return probs, top_p / top_p.sum(-1, keepdim=True), top_e


def grouped_ffn(p, xs, ends):
    """The experts' SwiGLU over rows sorted by expert (the reference's
    three ``lax.ragged_dot`` products): rows ``[ends[e - 1], ends[e])`` go
    through expert ``e``, rows past ``ends[-1]`` give zeros.  ``ends``
    (int32) stays on xs's device: on the card ``grouped_mm`` reads it
    there, so the host never waits for the group sizes."""
    g = grouped_mm(xs, p["w_gate"], ends)
    u = grouped_mm(xs, p["w_up"], ends)
    return grouped_mm(_gate(g, u, ends), p["w_down"], ends)


def _gate(g, u, ends):
    """silu(g) * u.  On the CPU it runs per expert segment (the ends read
    there, as ``grouped_mm``'s plain version reads them): a vectorised
    elementwise op on the CPU rounds a tensor's last few elements through
    its scalar path, so per segment keeps the bits that per-expert
    SwiGLUs give."""
    if g.device.type != "cpu":
        return silu(g) * u
    b = [0, *ends.tolist(), g.shape[0]]
    segs = [silu(g[s:t]) * u[s:t] for s, t in zip(b, b[1:]) if t > s]
    return torch.cat(segs) if segs else silu(g) * u


def _expert_sum(p, xs_src, top_p, top_e, n_groups: int, top_k: int):
    """Each token's sum, over its k choices, of routing weight times its
    expert's output, for the choices with an expert id in [0, n_groups);
    an id of ``n_groups`` stands for an expert held elsewhere and adds
    nothing.  ``xs_src`` (N, d) are the tokens the experts read; ``p``
    holds the n_groups experts' stacks.

    The assignments are sorted by expert with a stable sort (as
    ``jnp.argsort``), so each expert's rows are one contiguous segment,
    and the segments' running ends stay on the device.  The routing
    weights are cast to the products' dtype before the multiply.  The
    reference's scatter-add adds a token's k weighted rows into zeros in
    sorted order, i.e. by ascending expert id; here they are gathered
    back and added in that order, so the sum is the same and
    deterministic on the card (``index_add_`` there adds with atomics, in
    no fixed order).  Returns (out (N, d), counts (n_groups + 1,))."""
    N = xs_src.shape[0]
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    # (bincount would read the largest id to the host)
    counts = torch.zeros(n_groups + 1, dtype=torch.long,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    ends = torch.cumsum(counts[:n_groups], 0).to(torch.int32)
    ys = grouped_ffn(p, xs_src[order // top_k], ends)
    w = top_p.reshape(-1)[order].to(ys.dtype)
    contrib = ys * w[:, None]
    # sorted position of each (token, choice); a token's experts are
    # distinct, so its positions in ascending order are its experts in
    # ascending id
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    rank = rank.view(N, top_k).sort(dim=1).values
    out = torch.zeros_like(xs_src)
    for j in range(top_k):
        out = out + contrib[rank[:, j]]
    return out, counts


def moe_ffn(p, x, *, top_k: int):
    """Token-choice top-k MoE (``repro/models/layers.py:577``): every
    assignment is computed (no capacity, nothing dropped), so a padding
    row of a bucketed feed cannot change a real row.  The experts'
    products are ``grouped_mm`` over the assignments sorted by expert
    (:func:`_expert_sum`), with the group offsets on the device: no host
    sync, and the call traces on ``meta``.  Over DTensors it runs as
    :func:`_moe_ffn_sharded`.
    x: (B, T, d).  Returns (out (B, T, d), the Switch load-balance aux
    loss, f32)."""
    if any(isinstance(t, DTensor) for t in (x, p["router"], p["w_gate"],
                                            p["w_up"], p["w_down"])):
        return _moe_ffn_sharded(p, x, top_k=top_k)
    B, T, d = x.shape
    E = p["router"].shape[1]
    xf = x.reshape(-1, d)
    probs, top_p, top_e = moe_route(p["router"], xf, top_k)
    out, counts = _expert_sum(p, xf, top_p, top_e, E, top_k)
    if "shared" in p:
        out = out + mlp(p["shared"], xf)
    # Switch-style load-balance auxiliary loss
    frac = counts[:E].float() / top_e.numel()
    aux = E * torch.sum(frac * probs.mean(0))
    return out.reshape(B, T, d), aux


def _moe_ffn_sharded(p, x, *, top_k: int):
    """:func:`moe_ffn` over DTensors (``moe_ffn_ep`` hands it a batch the
    data axes do not divide, e.g. the dry run's B = 1 ``long_500k``): a
    ``local_map`` region over the ``moe_mesh`` hint's mesh (else the
    mesh of the first DTensor, its non-"model" axes taken as data axes).

    Layout: experts E over "model" (each model rank owns E / msz
    experts; where msz does not divide E they are replicated), the
    experts' d gathered over "data" as the region takes them, tokens over
    the data axes where they divide the batch, else replicated.  Each
    model rank computes, through ``grouped_mm`` on its own experts and
    its own ends, every assignment to its experts -- all of them, as
    ``moe_ffn`` does, with no capacity -- and one all-reduce over "model"
    sums the experts' contributions.  The experts are never gathered
    over "model".  Inputs that every rank of an axis holds alike but that
    feed a computation differing over it go through ``shardctx.pvary``
    (the router and the experts over the token axes, the tokens and
    their routing weights over "model"), so their gradients are summed
    over those ranks.  The aux loss's ``frac`` and ``mean_prob`` are
    averaged over the token axes.  The shared expert is added after."""
    hint = shardctx.get("moe_mesh")
    if hint is None:
        raise ValueError("moe_ffn over DTensors needs the moe_mesh hint "
                         "(shardctx.hints(moe_mesh=(mesh, data axes)))")
    mesh, data_axes = hint
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    B, T, d = x.shape
    E = p["router"].shape[1]
    msz = sizes.get("model", 1)
    e_axes = ("model",) if msz > 1 and E % msz == 0 else ()
    E_loc = E // msz if e_axes else E
    dsz = math.prod(sizes.get(a, 1) for a in data_axes)
    tok_axes = tuple(data_axes) if dsz > 1 and B % dsz == 0 else ()
    n_tok = dsz if tok_axes else 1

    def region(xl, router, wg, wu, wd):
        # xl: (B / n_tok, T, d); router: (d, E); wg/wu: (E_loc, d, dff);
        # wd: (E_loc, dff, d)
        xf = xl.reshape(-1, d)
        probs, top_p, top_e = moe_route(
            shardctx.pvary(router, mesh, tok_axes), xf, top_k)
        r = mesh.get_local_rank("model") if e_axes else 0
        e_loc = top_e - r * E_loc
        e_loc = torch.where((e_loc >= 0) & (e_loc < E_loc), e_loc, E_loc)
        experts = {n: shardctx.pvary(t, mesh, tok_axes) for n, t in
                   (("w_gate", wg), ("w_up", wu), ("w_down", wd))}
        out, _ = _expert_sum(
            experts, shardctx.pvary(xf, mesh, e_axes),
            shardctx.pvary(top_p, mesh, e_axes), e_loc, E_loc, top_k)
        out = shardctx.psum(out, mesh, e_axes)
        counts = torch.zeros(E, dtype=torch.long, device=xf.device)
        counts = counts.scatter_add(0, top_e.reshape(-1),
                                    torch.ones_like(top_e.reshape(-1)))
        frac = shardctx.psum(counts.float() / top_e.numel(), mesh,
                             tok_axes) / n_tok
        mean_prob = shardctx.psum(probs.mean(0), mesh, tok_axes) / n_tok
        aux = E * torch.sum(frac * mean_prob)
        return out.reshape(xl.shape).to(xl.dtype), aux

    def place(**shards):
        return tuple(Shard(shards[a]) if a in shards else Replicate()
                     for a in mesh.mesh_dim_names)

    tokens = place(**{a: 0 for a in tok_axes})
    experts = place(**{a: 0 for a in e_axes})
    plain = not isinstance(x, DTensor)
    out, aux = local_map(
        region, out_placements=(tokens, place()),
        in_placements=(tokens, place(), experts, experts, experts),
        device_mesh=mesh, redistribute_inputs=True,
    )(*(shardctx.as_dtensor(t, mesh) for t in
        (x, p["router"], p["w_gate"], p["w_up"], p["w_down"])))
    if plain:
        out, aux = out.full_tensor(), aux.to_local()
    if "shared" in p:
        out = out + mlp(p["shared"], x.reshape(-1, d)).reshape(B, T, d)
    return out, aux


def moe_ffn_ep(p, x, *, top_k: int, capacity_factor: float = 2.0):
    """Expert-parallel MoE (``repro/models/layers.py:625``) as a
    ``local_map`` region over the ``moe_mesh`` hint's mesh.

    Layout: experts E over "model" (each model rank owns E / msz experts),
    the experts' d over "data" (all-gathered in the region), tokens over
    the data axes.  Each rank computes, for its local tokens, the
    contributions of its own experts only: its assignments are sorted by
    local expert with a stable sort (the reference's ``jnp.argsort``), the
    first C kept (C = N_loc * k / msz * cf, at least 8, rounded up to 8,
    at most N_loc * k), each expert's rows placed into a fixed (E_loc, Ce,
    d) bucket (Ce = C up to 256 rows, else C / E_loc, at least 8; rows
    past an expert's capacity are dropped, GShard semantics) and taken
    through three batched products; then one all-reduce over "model"
    sums the experts' contributions.  The aux loss's ``frac`` and
    ``mean_prob`` are averaged over the data axes.  The shared expert is
    added after.

    With no ``moe_mesh`` hint, or with shapes the mesh does not divide,
    this is :func:`moe_ffn`: the reference's own semantics
    (``layers.py:644-646, :657-659``), not a device fallback.  Plain
    tensors are taken as the global (replicated) tensors and a plain
    result is returned."""
    hint = shardctx.get("moe_mesh")
    if hint is None:
        return moe_ffn(p, x, top_k=top_k)
    mesh, data_axes = hint
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    msz = sizes.get("model", 1)
    B, T, d = x.shape
    E = p["router"].shape[1]
    E_loc = E // msz
    dsz = 1
    for a in data_axes:
        dsz *= sizes.get(a, 1)
    if (E_loc * msz != E or B % dsz != 0 or d % dsz != 0
            or p["w_down"].shape[-1] % dsz != 0):
        return moe_ffn(p, x, top_k=top_k)
    B_loc = B // dsz
    N_loc = B_loc * T
    C = max(int(N_loc * top_k / msz * capacity_factor), 8)
    C = -(-C // 8) * 8
    C = min(C, N_loc * top_k)   # cannot keep more assignments than exist
    Ce = C if C <= 256 else max(C // E_loc, 8)
    data_dim = mesh.mesh_dim_names.index("data")

    def region(xl, router, wg, wu, wd):
        # xl: (B_loc, T, d); router: (d, E);
        # wg/wu: (E_loc, d_loc, dff); wd: (E_loc, dff, d_loc)
        # the router meets each data rank's own tokens, and the tokens
        # and their weights each model rank's own experts: their
        # gradients are summed over those ranks
        xf = xl.reshape(N_loc, d)
        probs, top_p, top_e = moe_route(
            shardctx.pvary(router, mesh, data_axes), xf, top_k)
        r = mesh.get_local_rank("model")
        e_flat = top_e.reshape(-1)
        w_flat = shardctx.pvary(top_p.reshape(-1), mesh, ("model",))
        local = (e_flat // E_loc) == r
        e_loc = torch.where(local, e_flat - r * E_loc, E_loc)  # E_loc: other
        keep = torch.argsort(e_loc, stable=True)[:C]      # others last
        e_keep = e_loc[keep]
        valid = e_keep < E_loc
        tok = keep // top_k
        xs = shardctx.pvary(xf, mesh, ("model",))[tok]     # (C, d)
        gs = torch.zeros(E_loc + 1, dtype=torch.long, device=xf.device)
        gs = gs.scatter_add(0, e_keep, torch.ones_like(e_keep))[:E_loc]

        # the experts' d is sharded over "data" only: gather that dim
        grp = (mesh, data_dim)
        wg_f = funcol.all_gather_tensor_autograd(wg, 1, grp)
        wu_f = funcol.all_gather_tensor_autograd(wu, 1, grp)
        wd_f = funcol.all_gather_tensor_autograd(wd, 2, grp)

        e_cl = torch.where(valid, e_keep, 0)
        offs = torch.cumsum(gs, 0) - gs
        slot = torch.arange(C, device=xf.device) - offs[e_cl]
        in_cap = valid & (slot < Ce) & (slot >= 0)
        slot_w = torch.where(in_cap, slot, Ce)   # Ce: the dropped rows
        buf = xs.new_zeros(E_loc, Ce + 1, d).index_put(
            (e_cl, slot_w), xs)[:, :Ce]
        g = torch.einsum("ecd,edf->ecf", buf, wg_f)
        u = torch.einsum("ecd,edf->ecf", buf, wu_f)
        ys_buf = torch.einsum("ecf,efd->ecd", silu(g) * u, wd_f)
        ys = ys_buf[e_cl, slot_w.clamp(max=Ce - 1)]        # (C, d)

        wk = torch.where(in_cap, w_flat[keep], 0.0).to(ys.dtype)
        out = ys.new_zeros(N_loc, d).index_add(0, tok, ys * wk[:, None])
        out = shardctx.psum(out, mesh, ("model",))

        counts = torch.zeros(E, dtype=torch.long, device=xf.device)
        counts = counts.scatter_add(0, e_flat, torch.ones_like(e_flat))
        frac = shardctx.psum(counts.float() / e_flat.numel(), mesh,
                             data_axes) / dsz
        mean_prob = shardctx.psum(probs.mean(0), mesh, data_axes) / dsz
        aux = E * torch.sum(frac * mean_prob)
        return out.reshape(B_loc, T, d).to(xl.dtype), aux

    def place(**shards):
        return tuple(Shard(shards[a]) if a in shards else Replicate()
                     for a in mesh.mesh_dim_names)

    tokens = place(**{a: 0 for a in data_axes})
    plain = not isinstance(x, DTensor)

    out, aux = local_map(
        region, out_placements=(tokens, place()),
        in_placements=(tokens, place(), place(model=0, data=1),
                       place(model=0, data=1), place(model=0, data=2)),
        device_mesh=mesh, redistribute_inputs=True,
    )(*(shardctx.as_dtensor(t, mesh) for t in
        (x, p["router"], p["w_gate"], p["w_up"], p["w_down"])))
    if plain:
        out, aux = out.full_tensor(), aux.to_local()
    if "shared" in p:
        out = out + mlp(p["shared"], x.reshape(-1, d)).reshape(B, T, d)
    return out, aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0), with no
    linear cut-off (torch's ``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: (B, L, C), w: (W, C).  The W products
    are summed in x's dtype in the order i = 0..W-1, as the reference."""
    W, L = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    y = xp[:, 0:L] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + L] * w[i]
    return y + b


def conv_step(conv_state, x_t, w, b):
    """conv_state: (B, W-1, C), x_t: (B, T, C) with T small (decode chunk).
    Returns (y (B, T, C), new_state (B, W-1, C))."""
    full = torch.cat([conv_state, x_t], dim=1)
    W1 = conv_state.shape[1]
    y = causal_conv1d(full, w, b)[:, W1:]
    new_state = full[:, full.shape[1] - W1:] if W1 else conv_state
    return y, new_state


def _segsum(dA):
    """dA: (..., q, h) -> L (..., h, q, q) with L[i,j]=exp(sum_{j<k<=i} dA).

    The masked (j > i) entries have POSITIVE diff (dA is negative), so
    exp overflows there; the mask is applied BEFORE the exp."""
    q = dA.shape[-2]
    dAc = torch.cumsum(dA, dim=-2).transpose(-1, -2)      # (..., h, q)
    diff = dAc[..., :, None] - dAc[..., None, :]           # (..., h, q, q)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=dA.device))
    return torch.exp(torch.where(mask, diff, NEG_INF))


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """Chunked SSD scan ("Transformers are SSMs", Alg. 1 / minimal impl).

    x: (B, L, H, P); dt: (B, L, H) (already softplus'd);
    A: (H,) negative; Bm, Cm: (B, L, N) (single group).
    Returns (y (B, L, H, P), h_final (B, H, P, N)).

    The reference's four-operand einsums are written as pairwise
    products: M = scores o Lmat o dt is formed as (B, C, H, Q, Q) and
    applied to x with one batched matmul, never a (.., Q, Q, P) tensor.
    """
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    assert L % Q == 0, f"seq {L} not divisible by chunk {Q}"
    C_ = L // Q

    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    dA = dtf * A                                           # (B, L, H)

    xc = xf.reshape(Bsz, C_, Q, H, P)
    dtc = dtf.reshape(Bsz, C_, Q, H)
    dAc = dA.reshape(Bsz, C_, Q, H)
    Bc = Bf.reshape(Bsz, C_, Q, N)
    Cc = Cf.reshape(Bsz, C_, Q, N)
    xh = xc.permute(0, 1, 3, 2, 4)                         # (B, C, H, Q, P)

    # Intra-chunk (dual quadratic form)
    Lmat = _segsum(dAc)                                    # (B, C, H, Q, Q)
    scores = Cc @ Bc.transpose(-1, -2)                     # (B, C, Q, Q)
    M = scores[:, :, None] * Lmat * dtc.transpose(-1, -2)[:, :, :, None, :]
    Yd = M @ xh                                            # (B, C, H, Q, P)

    # Chunk states
    dA_cum = torch.cumsum(dAc, dim=2)                      # (B, C, Q, H)
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    w = (decay_states * dtc).transpose(-1, -2)             # (B, C, H, Q)
    states = (xh * w[..., None]).transpose(-1, -2) @ Bc[:, :, None]
    # states: (B, C, H, P, N)

    # Inter-chunk recurrence
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])           # (B, C, H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for c in range(C_):
        h_prev.append(h)                  # the state *entering* chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                    # (B, C, H, P, N)

    # Off-diagonal (inter-chunk) contribution
    Yo = (Cc[:, :, None] @ h_prev.transpose(-1, -2)) \
        * dA_cum.exp().transpose(-1, -2)[..., None]        # (B, C, H, Q, P)
    y = (Yd + Yo).permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P)
    return y.to(x.dtype), h


def ssd_decode(x, dt, A, Bm, Cm, h):
    """Single-token recurrent update.

    x: (B, 1, H, P), dt: (B, 1, H), Bm/Cm: (B, 1, N), h: (B, H, P, N).
    """
    xf, dtf = x[:, 0].float(), dt[:, 0].float()            # (B,H,P), (B,H)
    Bf, Cf = Bm[:, 0].float(), Cm[:, 0].float()            # (B,N)
    dA = torch.exp(dtf * A)                                # (B, H)
    upd = (dtf[..., None] * xf)[..., None] * Bf[:, None, None, :]
    h_new = h * dA[:, :, None, None] + upd
    y = (h_new @ Cf[:, None, :, None])[..., 0]             # (B, H, P)
    return y[:, None].to(x.dtype), h_new


def mamba_block(p, cfg, x, cache=None, *, return_importance=False):
    """Full Mamba2 block. x: (B, T, d).

    cache: {"conv": (B, W-1, C), "state": (B, H, P, N) f32} or None; the
    new conv window and state are written into those tensors in place.
    A multi-token forward runs the SSD scan through the ``ssd_scan``
    kernel when ``cfg.attn_impl == "pallas"``, else through its plain
    version (pad to a multiple of ``Q = min(chunk, T)``, then
    :func:`ssd_chunked`, the reference's path); one token over a cache is
    :func:`ssd_decode`.  When autograd tracks the scan's inputs (a
    training forward) the plain version runs under every ``attn_impl``:
    the kernel has no gradient, and the reference's model path always
    trains through ``ssd_chunked``.  The choice is made from the grad
    mode before any launch, never on a failure.  Importance analogue
    for SSMs: per-token mean |dt * x|.  Returns (out, cache, importance
    (B, T) or None).
    """
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    B, T, _ = x.shape

    proj = x @ p["in_proj"]
    z, xbc, dt_raw = proj.split([di, di + 2 * N, H], dim=-1)

    if cache is not None:
        xbc, new_conv = conv_step(cache["conv"], xbc, p["conv_w"],
                                  p["conv_b"])
    else:
        xbc = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
    xbc = silu(xbc)
    xs, Bm, Cm = xbc.split([di, N, N], dim=-1)

    dt = softplus(dt_raw.float() + p["dt_bias"])           # (B, T, H)
    A = -torch.exp(p["A_log"])                             # (H,)
    # pin the scan's inputs and output to batch sharding, as the blocked
    # attention's K/V: a mesh must not shard the sequence the scan cuts
    # into chunks
    xh, dt, Bm, Cm = (shardctx.constrain_batch_dim(t, 0) for t in
                      (xs.reshape(B, T, H, P), dt, Bm, Cm))

    if cache is not None and T == 1:
        y, new_state = ssd_decode(xh, dt, A, Bm, Cm, cache["state"].float())
    else:
        h0 = cache["state"].float() if cache is not None else None
        tracked = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, Bm, Cm))
        scan = (ssd_scan if cfg.attn_impl == "pallas" and not tracked
                else ssd_scan_ref)
        y, new_state = scan(xh.contiguous(), dt, A, Bm.contiguous(),
                            Cm.contiguous(), chunk=cfg.ssm_chunk, h0=h0)
        # (and its gradient, which a redistribution's backward lays out
        # as the forward output was)
        y = shardctx.constrain_batch_dim(y, 0)
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(B, T, di)
    y = gated_rms_norm(y, z, p["gate_norm"], cfg.norm_eps)
    out = row_parallel_out(y @ p["out_proj"])

    imp = None
    if return_importance:
        imp = (dt[..., None] * xh.float()).abs().mean(dim=(-1, -2))

    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
    return out, cache, imp


def init_mamba_cache(cfg, batch, dtype, *, layers: tuple, device):
    """Per-layer conv windows and SSM states, stacked over the leading
    axes ``layers`` ((n,) for a layer stack, (rounds, per round) for the
    hybrid): {"conv": (*layers, batch, W-1, C) dtype, "state": (*layers,
    batch, H, P, N) f32}, zeros."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    convC = di + 2 * N
    return {
        "conv": torch.zeros((*layers, batch, cfg.ssm_conv_width - 1, convC),
                            dtype=dtype, device=device),
        "state": torch.zeros((*layers, batch, H, P, N), dtype=torch.float32,
                             device=device),
    }
