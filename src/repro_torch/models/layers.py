"""Neural building blocks of the dense decoder (port of
``repro/models/layers.py``, dense-family subset).

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
                   ``attn_importance`` for the device draft path.  The
                   name is kept from the reference so one ``ModelConfig``
                   drives both packages.

KV caches are updated in place (the reference donates them to jit).
The paged cache layout (``cache_impl="paged"``) arrives with the next
slice of the port, together with its block-table kernels.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.attn_importance import attn_with_importance
from repro_torch.kernels.decode_gqa import decode_attention
from repro_torch.kernels.partial_prefill import partial_prefill_attention

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


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache + core)
# ---------------------------------------------------------------------------

def attn_block(p, x, positions, cfg, cache=None, *, kv_pos=None, causal=True,
               rope=True, window=0, return_importance=False, n_heads=None,
               n_kv=None, write_index=None):
    """Self-attention with optional cache.

    x: (B, T, d).  If ``cache`` is given, new K/V are written into it (in
    place) and attention runs over the whole buffer.
    Returns (out, cache, importance).
    """
    if is_paged(cache):
        raise NotImplementedError(
            "paged KV caches arrive with the next slice of the port "
            "(block allocator, paged engine and block-table kernels)")
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

    if cache is not None:
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
