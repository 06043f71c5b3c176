"""Model assembly for the dense family (port of ``repro/models/model.py``).

Parameters are nested dicts of tensors with the reference's structure and
names; every per-layer leaf keeps the stacked leading layer axis that the
reference scans with ``lax.scan``, and ``forward`` loops over it in
Python.  Caches are dicts of the same shape, updated in place.

Conventions (as in the reference):
* ``positions`` is always (B, T) int absolute positions;
* ``forward(...)`` returns ``(logits, cache, importance, aux_loss)``;
* ``window`` > 0 enables sliding-window attention over a circular cache.

Only ``family="dense"`` with ``cache_impl="dense"`` is ported so far; the
other families and the paged cache raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.runtime import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _check_ported(cfg, cache_impl: str = "dense"):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    if cache_impl != "dense":
        raise NotImplementedError(
            "cache_impl='paged' arrives with the next slice of the port")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg, seed: int = 0, *, device=None):
    """Random parameters with the reference's shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from ``jax.random``; use ``repro_torch.bridge`` to
    load the reference's own parameters)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, scale):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    V, d, n = cfg.vocab, cfg.d_model, cfg.n_layers
    nh, nkv, hd, dff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    sd = 1.0 / math.sqrt(d)
    params = {"embed": normal(V, d, scale=0.02), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal(d, V, scale=sd)
    attn = {
        "wq": normal(n, d, nh * hd, scale=sd),
        "wk": normal(n, d, nkv * hd, scale=sd),
        "wv": normal(n, d, nkv * hd, scale=sd),
        "wo": normal(n, nh * hd, d, scale=sd / math.sqrt(2.0)),
    }
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((n, nh * hd), dtype=dt, device=dev)
        attn["bk"] = torch.zeros((n, nkv * hd), dtype=dt, device=dev)
        attn["bv"] = torch.zeros((n, nkv * hd), dtype=dt, device=dev)
    params["layers"] = {
        "ln1": ones(n, d),
        "ln2": ones(n, d),
        "attn": attn,
        "mlp": {
            "w_gate": normal(n, d, dff, scale=sd),
            "w_up": normal(n, d, dff, scale=sd),
            "w_down": normal(n, dff, d, scale=1.0 / math.sqrt(dff)),
        },
    }
    return params


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, s_max: int, *, cache_impl: str | None = None,
               device=None):
    """Dense serving cache: one contiguous (batch, s_max) buffer per layer
    (``s_max`` is the attention buffer length), positions -1 = empty."""
    impl = cache_impl or getattr(cfg, "cache_impl", "dense")
    _check_ported(cfg, impl)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "pos": torch.full(shape[:3], -1, dtype=torch.int32, device=dev),
    }}


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _layer(cfg, p, h, pos, cache, *, window=0, ret_imp=False,
           write_index=None):
    a_in = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    a, nc, imp = L.attn_block(
        p["attn"], a_in, pos, cfg, cache, window=window,
        return_importance=ret_imp, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        write_index=write_index)
    h = h + a
    f_in = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + L.mlp(p["mlp"], f_in), nc, imp


def forward(cfg, params, tokens, positions, cache=None, *, window: int = 0,
            return_importance: bool = False):
    """tokens: (B, T) int; positions: (B, T) int.

    Returns (logits (B, T, V), cache, importance (B, S) or None, aux_loss).
    ``cache`` is updated in place and returned (None without a cache).
    """
    _check_ported(cfg)
    h = params["embed"][tokens]
    windex = None
    if cache is not None:
        windex = L.cache_write_index(positions, cache["layers"]["k"].shape[2])
    imps = []
    for i in range(cfg.n_layers):
        lc = layer_slice(cache["layers"], i) if cache is not None else None
        h, _, imp = _layer(cfg, layer_slice(params["layers"], i), h,
                           positions, lc, window=window,
                           ret_imp=return_importance, write_index=windex)
        if return_importance:
            imps.append(imp)
    imp = torch.stack(imps).mean(0) if return_importance else None
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    unemb = (params["embed"].T if cfg.tie_embeddings else params["unembed"])
    logits = h @ unemb
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return logits, cache, imp, aux


def default_positions(batch: int, seq: int, *, device=None):
    dev = resolve_device(device)
    return torch.arange(seq, dtype=torch.int32, device=dev)[None].expand(
        batch, seq)
