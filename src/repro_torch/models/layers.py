"""Neural building blocks of the dense decoder (port of
``repro/models/layers.py``, dense-family subset, dense and paged KV
caches).

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
                   ``ModelConfig`` drives both packages.

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

from repro_torch.kernels.attn_importance import attn_with_importance
from repro_torch.kernels.decode_gqa import (decode_attention,
                                            decode_attention_paged)
from repro_torch.kernels.partial_prefill import (
    partial_prefill_attention, partial_prefill_attention_paged)

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


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def apply_rope(x, positions, theta: float):
    """x: (B, T, n_heads, head_dim); positions: (B, T) int."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=x.device), exps)
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
                     causal: bool = True, return_importance: bool = False):
    """Dispatch to the hand-written kernels (``cfg.attn_impl ==
    "pallas"``), exactly as the reference dispatches its Pallas kernels:

    * ``attn_importance``  -- importance fused into attention (device SLM
      draft path; windowed importance falls back to ``naive``)
    * ``decode_gqa``       -- T == 1 cached decode
    * ``partial_prefill``  -- chunked verification over a cached prefix
    """
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
    out = partial_prefill_attention(q, k, v, q_pos, kv_pos, window=window)
    return out, None


def attention(q, k, v, q_pos, kv_pos, *, impl: str = "blocked",
              block_kv: int = 1024, window: int = 0, causal: bool = True,
              return_importance: bool = False):
    if impl == "pallas" and causal:
        return pallas_attention(q, k, v, q_pos, kv_pos, window=window,
                                causal=causal,
                                return_importance=return_importance)
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


def cache_write_index(positions, s_max: int):
    """Where ``cache_write`` puts each token: ``(b_idx, t_idx, slot)`` for
    the non-negative positions only.  Negative positions mark padding and
    are dropped here -- the reference routes them to an out-of-bounds
    slot that XLA's scatter silently drops; torch indexing would raise
    instead.  Computed once per forward and shared by every layer (one
    host sync on CUDA)."""
    b_idx, t_idx = (positions >= 0).nonzero(as_tuple=True)
    return b_idx, t_idx, positions[b_idx, t_idx].long() % s_max


def cache_write(cache, k_new, v_new, positions, index=None):
    """Write new K/V in place at slots ``positions % s_max`` (circular
    when windowed).  Padding (position -1) never touches the cache.
    ``index`` is :func:`cache_write_index` for these positions, when the
    caller already has it.  Returns ``cache``."""
    if index is None:
        index = cache_write_index(positions, cache["k"].shape[1])
    b_idx, t_idx, slot = index
    cache["k"][b_idx, slot] = k_new[b_idx, t_idx].to(cache["k"].dtype)
    cache["v"][b_idx, slot] = v_new[b_idx, t_idx].to(cache["v"].dtype)
    cache["pos"][b_idx, slot] = positions[b_idx, t_idx].to(torch.int32)
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
    and ``kv_splits`` cut the table into the reference's split ranges."""
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
    through its block table).  ``write_index`` is the cache's write index
    for ``positions`` (:func:`cache_write_index` or
    :func:`paged_write_index`), when the caller already has it.
    Returns (out, cache, importance).
    """
    nh = n_heads if n_heads is not None else cfg.n_heads
    nkv = n_kv if n_kv is not None else cfg.n_kv_heads
    hd = cfg.head_dim
    B, T, _ = x.shape

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, T, nh, hd)
    k = k.reshape(B, T, nkv, hd)
    v = v.reshape(B, T, nkv, hd)

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
            return out.reshape(B, T, nh * hd) @ p["wo"], cache, None
        k_all, v_all, kv_positions = paged_kv_view(cache)
    elif cache is not None:
        cache_write(cache, k, v, positions, write_index)
        k_all, v_all, kv_positions = cache["k"], cache["v"], cache["pos"]
    else:
        k_all, v_all, kv_positions = k, v, src_pos

    out, imp = attention(
        q, k_all, v_all, positions, kv_positions,
        impl=cfg.attn_impl, block_kv=cfg.attn_block_kv, window=window,
        causal=causal, return_importance=return_importance)
    out = out.reshape(B, T, nh * hd) @ p["wo"]
    return out, cache, imp


# ---------------------------------------------------------------------------
# FFN: dense SwiGLU
# ---------------------------------------------------------------------------

def mlp(p, x):
    return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
