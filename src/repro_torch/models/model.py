"""Model assembly and family-dispatched forward (port of
``repro/models/model.py``).

Parameters are nested dicts of tensors with the reference's structure and
names; every per-layer leaf keeps the stacked leading layer axes that the
reference scans with ``lax.scan`` (one for a layer stack, two -- round,
then layer -- for the hybrid's Mamba2 rounds and the vlm's self layers),
and ``forward`` loops over them in Python.  Caches are dicts of the same
shape, updated in place.

Conventions (as in the reference):
* ``positions`` is always (B, T) int absolute positions;
* ``forward(...)`` returns ``(logits, cache, importance, aux_loss)``;
* ``window`` > 0 enables sliding-window attention over a circular cache.

Every family of the reference is ported: ``dense`` and ``moe`` (every
layer's FFN an MoE, or dense and MoE layers interleaved in rounds) with a
dense or a paged cache; ``ssm`` (Mamba2, per-layer conv windows and SSM
states; nothing to page); ``hybrid`` (zamba2: rounds of Mamba2 layers,
each followed by one weight-shared MHA block with its own KV cache);
``vlm`` (rounds of self-attention layers, each closed by a gated
cross-attention layer over projected image embeddings) and ``audio``
(whisper: a non-causal encoder over audio frames, then decoder layers
with self- and cross-attention).  The last four take the dense cache
only.  The vlm and audio forwards take their frontend's output through
``aux_inputs`` (``{"image_embeds"}`` / ``{"audio_frames"}``, in the
model's dtype); with it, a cached forward also writes the cross cache,
which later cached forwards read.

Training: :func:`lm_loss` is the reference's loss.  A forward without a
cache whose parameters require grad (a training forward) takes each
stacked leaf's layers by one ``torch.unbind`` (:func:`layer_trees`) and,
when ``cfg.remat``, recomputes each layer in backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import shardctx
from repro_torch.runtime import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
# the frontend output each family's forward takes through ``aux_inputs``
AUX_INPUTS = {"vlm": "image_embeds", "audio": "audio_frames"}


def torch_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg, seed: int = 0, *, device=None):
    """Random parameters with the reference's shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from ``jax.random``; use ``repro_torch.bridge`` to
    load the reference's own parameters).  On ``device="meta"`` every
    leaf is an empty tensor of its shape and dtype and nothing is drawn
    (the dry run's parameters)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    meta = dev.type == "meta"
    gen = None if meta else torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, scale, dtype=dt):
        if meta:
            return torch.empty(shape, dtype=dtype, device=dev)
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def experts(*lead, rows, cols, scale):
        # drawn one (layer, expert) matrix at a time: a whole expert leaf
        # drawn in f32 would not fit the card beside the bf16 weights
        out = torch.empty((*lead, cfg.n_experts, rows, cols), dtype=dt,
                          device=dev)
        for idx in np.ndindex(*lead, cfg.n_experts) if not meta else ():
            out[idx] = normal(rows, cols, scale=scale)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    V, d = cfg.vocab, cfg.d_model
    sd = 1.0 / math.sqrt(d)
    params = {"embed": normal(V, d, scale=0.02), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal(d, V, scale=sd)

    def mamba(*lead):
        # init_mamba: A_log, D and dt_bias are f32 whatever the model dtype
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        convC = di + 2 * N
        a_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
        return {
            "in_proj": normal(*lead, d, 2 * di + 2 * N + H, scale=sd),
            "conv_w": normal(*lead, cfg.ssm_conv_width, convC, scale=0.1),
            "conv_b": torch.zeros((*lead, convC), dtype=dt, device=dev),
            "A_log": a_log.expand(*lead, H).clone(),
            "D": torch.ones((*lead, H), device=dev),
            "dt_bias": torch.zeros((*lead, H), device=dev),
            "gate_norm": ones(*lead, di),
            "out_proj": normal(*lead, di, d, scale=1.0 / math.sqrt(di)),
        }

    def mlp(*lead, dff):
        return {
            "w_gate": normal(*lead, d, dff, scale=sd),
            "w_up": normal(*lead, d, dff, scale=sd),
            "w_down": normal(*lead, dff, d, scale=1.0 / math.sqrt(dff)),
        }

    def moe(*lead):
        # init_moe: the router is f32 whatever the model dtype
        dff = cfg.d_ff
        p = {
            "router": normal(*lead, d, cfg.n_experts, scale=sd,
                             dtype=torch.float32),
            "w_gate": experts(*lead, rows=d, cols=dff, scale=sd),
            "w_up": experts(*lead, rows=d, cols=dff, scale=sd),
            "w_down": experts(*lead, rows=dff, cols=d,
                              scale=1.0 / math.sqrt(dff)),
        }
        if cfg.n_shared_experts:
            p["shared"] = mlp(*lead, dff=cfg.n_shared_experts * dff)
        return p

    def attn(*lead, nkv, bias):
        # layers.init_attn
        nh, hd = cfg.n_heads, cfg.head_dim
        p = {
            "wq": normal(*lead, d, nh * hd, scale=sd),
            "wk": normal(*lead, d, nkv * hd, scale=sd),
            "wv": normal(*lead, d, nkv * hd, scale=sd),
            "wo": normal(*lead, nh * hd, d, scale=sd / math.sqrt(2.0)),
        }
        if bias:
            for name, width in (("bq", nh), ("bk", nkv), ("bv", nkv)):
                p[name] = torch.zeros((*lead, width * hd), dtype=dt,
                                      device=dev)
        return p

    def dense_layer(*lead, mha=False, ffn="mlp", dff=None):
        # _init_dense_layer: mha=True gives n_kv = n_heads
        nkv = cfg.n_heads if mha else cfg.n_kv_heads
        p = {"ln1": ones(*lead, d), "ln2": ones(*lead, d),
             "attn": attn(*lead, nkv=nkv, bias=cfg.qkv_bias)}
        if ffn == "mlp":
            p["mlp"] = mlp(*lead, dff=dff or cfg.d_ff)
        else:
            p["moe"] = moe(*lead)
        return p

    def cross_layer(*lead):
        # _init_cross_layer: the tanh gates start at zero (a no-op layer)
        return {"ln1": ones(*lead, d), "ln2": ones(*lead, d),
                "attn": attn(*lead, nkv=cfg.n_kv_heads, bias=cfg.qkv_bias),
                "gate_attn": torch.zeros((*lead, 1), dtype=dt, device=dev),
                "gate_ffn": torch.zeros((*lead, 1), dtype=dt, device=dev),
                "mlp": mlp(*lead, dff=cfg.d_ff)}

    def encdec_layer(*lead):
        # _init_encdec_layer: no QKV bias whatever the config
        return {"ln1": ones(*lead, d), "lnx": ones(*lead, d),
                "ln2": ones(*lead, d),
                "self_attn": attn(*lead, nkv=cfg.n_kv_heads, bias=False),
                "cross_attn": attn(*lead, nkv=cfg.n_kv_heads, bias=False),
                "mlp": mlp(*lead, dff=cfg.d_ff)}

    if cfg.family == "ssm":
        params["layers"] = mamba(cfg.n_layers)
    elif cfg.family == "hybrid":
        params["mamba_rounds"] = mamba(cfg.n_layers // cfg.attn_every,
                                       cfg.attn_every)
        params["shared_attn"] = dense_layer(mha=True)
    elif cfg.family == "moe" and cfg.moe_every == 1:
        params["layers"] = dense_layer(cfg.n_layers, ffn="moe")
    elif cfg.family == "moe":
        rounds = cfg.n_layers // cfg.moe_every
        params["dense_layers"] = dense_layer(rounds, dff=cfg.d_ff_dense)
        params["moe_layers"] = dense_layer(rounds, ffn="moe")
    elif cfg.family == "vlm":
        rounds = cfg.n_layers // cfg.cross_attn_every
        params["self_layers"] = dense_layer(rounds, cfg.cross_attn_every - 1)
        params["cross_layers"] = cross_layer(rounds)
        params["vision_proj"] = normal(cfg.vision_dim, d,
                                       scale=1.0 / math.sqrt(cfg.vision_dim))
    elif cfg.family == "audio":
        params["enc_layers"] = dense_layer(cfg.n_encoder_layers)
        params["enc_norm"] = ones(d)
        params["dec_layers"] = encdec_layer(cfg.n_layers)
    else:
        params["layers"] = dense_layer(cfg.n_layers)
    return params


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, s_max: int, *, cache_impl: str | None = None,
               block_size: int | None = None, pool_blocks: int | None = None,
               device=None):
    """Serving cache.  ``s_max`` is the attention buffer length (the
    sliding window size for long-context decode); positions -1 = empty.

    ``cache_impl`` (default ``cfg.cache_impl``) selects the layout:

    * ``"dense"`` -- one contiguous (batch, s_max) buffer per layer (for
      ``family="moe"`` with ``moe_every`` > 1 two stacks, ``{"dense",
      "moe"}``, one buffer per round each, as the reference); for
      ``family="ssm"`` each layer's conv window and f32 SSM state instead
      (fixed size: ``s_max`` is not used); for ``family="hybrid"``
      ``{"mamba": ..., "attn": ...}``: the Mamba2 states with the two
      leading axes of ``mamba_rounds``, and one KV buffer per round (one
      per application of the shared attention block); for
      ``family="vlm"`` ``{"self": ..., "cross": ...}``: the self layers'
      KV buffers with the two leading axes of ``self_layers``, and one
      (batch, n_image_tokens) K/V pair per round; for ``family="audio"``
      the same with one KV buffer and one (batch, n_audio_frames) K/V
      pair per decoder layer.  The cross stacks have no ``pos``: every
      image token or audio frame is visible to every query.
    * ``"paged"`` -- a shared pool of ``pool_blocks`` blocks of
      ``block_size`` tokens (default ``cfg.kv_block_size``) per layer,
      plus one (batch, s_max / block_size) int32 ``block_tables`` map
      per stack, shared by the stack's layers (-1 = unmapped).
      ``pool_blocks`` defaults to dense capacity; serving engines pass a
      smaller pool and page slots on demand
      (``serving/engine.BlockAllocator``).  Only
      kv_stack families page: SSM/conv states have nothing to page.
    """
    _check_family(cfg)
    impl = cache_impl or getattr(cfg, "cache_impl", "dense")
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    n, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if impl == "paged":
        bs = block_size or cfg.kv_block_size
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"cache_impl='paged' supports dense/moe families (pure "
                f"kv_stack caches); got {cfg.family!r}")
        if s_max % bs:
            raise ValueError(f"s_max {s_max} not divisible by "
                             f"kv block size {bs}")
        max_bps = s_max // bs                 # blocks per slot
        nb = pool_blocks if pool_blocks is not None else batch * max_bps

        def kv_stack(n_stack):
            return {
                "k": torch.zeros((n_stack, nb, bs, nkv, hd), dtype=dt,
                                 device=dev),
                "v": torch.zeros((n_stack, nb, bs, nkv, hd), dtype=dt,
                                 device=dev),
                "pos": torch.full((n_stack, nb, bs), -1, dtype=torch.int32,
                                  device=dev),
                "block_tables": torch.full((batch, max_bps), -1,
                                           dtype=torch.int32, device=dev),
            }
    else:
        def kv_stack(n_stack):
            shape = (n_stack, batch, s_max, nkv, hd)
            return {
                "k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "pos": torch.full(shape[:3], -1, dtype=torch.int32,
                                  device=dev),
            }

    if cfg.family == "ssm":
        # fixed-size conv windows and SSM states: s_max is not used
        return {"layers": L.init_mamba_cache(cfg, batch, dt, layers=(n,),
                                             device=dev)}
    if cfg.family == "hybrid":
        rounds = n // cfg.attn_every
        return {"mamba": L.init_mamba_cache(cfg, batch, dt,
                                            layers=(rounds, cfg.attn_every),
                                            device=dev),
                "attn": kv_stack(rounds)}
    if cfg.family == "moe" and cfg.moe_every > 1:
        rounds = n // cfg.moe_every
        return {"dense": kv_stack(rounds), "moe": kv_stack(rounds)}

    def cross_stack(*lead, src_len):
        shape = (*lead, batch, src_len, nkv, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    if cfg.family == "vlm":
        rounds = n // cfg.cross_attn_every
        per = cfg.cross_attn_every - 1
        selfc = {k: v.reshape(rounds, per, *v.shape[1:])
                 for k, v in kv_stack(rounds * per).items()}
        return {"self": selfc,
                "cross": cross_stack(rounds, src_len=cfg.n_image_tokens)}
    if cfg.family == "audio":
        return {"self": kv_stack(n),
                "cross": cross_stack(n, src_len=cfg.n_audio_frames)}
    return {"layers": kv_stack(n)}


def layer_slice(tree, *index: int):
    """Layer ``index`` of a stacked parameter or cache tree (views): one
    index for a layer stack, two (round, layer) for the hybrid's
    ``mamba_rounds`` and the vlm's ``self_layers``.  A paged cache's
    ``block_tables`` and a slot view's ``slots`` have no layer axis and
    are shared as they are."""
    return {k: layer_slice(v, *index) if isinstance(v, dict)
            else v if k in ("block_tables", "slots") else v[index]
            for k, v in tree.items()}


def slot_view(cache, slots):
    """The cache as a forward over its batch rows ``slots`` ((n,) int32 on
    the cache's device) sees it, sharing the cache's tensors: each dense
    KV stack gains a ``slots`` leaf (its writes and attention address row
    ``slots[b]``), each paged stack's ``block_tables`` is cut to those
    rows (its kernels already address a slot by its table row).  None
    when some stack holds per-slot state that neither addresses: the
    cross-attention K/V of the vlm and audio families, SSM states."""
    if L.is_paged(cache):
        return dict(cache, block_tables=cache["block_tables"][slots])
    if "pos" in cache:
        return dict(cache, slots=slots)
    out = {}
    for k, v in cache.items():
        view = slot_view(v, slots) if isinstance(v, dict) else None
        if view is None:
            return None
        out[k] = view
    return out


def _training(tree) -> bool:
    """True in a training forward: grad mode is on and a leaf of ``tree``
    requires grad, so autograd records the forward."""
    return torch.is_grad_enabled() and any(
        _training(v) if isinstance(v, dict) else v.requires_grad
        for v in tree.values())


def _unbind(tree) -> list:
    """The layer trees of a stacked tree along its leading axis, by one
    ``torch.unbind`` per leaf."""
    parts = {k: _unbind(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def layer_trees(tree, n: int) -> list:
    """The first ``n`` layer trees of a stacked parameter tree along its
    leading axis (for the two-axis stacks, round trees, each still
    stacked over its layers).  In a training forward each leaf is
    unbound once: the backward of ``torch.unbind`` is one stack, where
    indexing each layer (:func:`layer_slice`) allocates a zero tensor of
    the whole stack per layer in backward, O(L^2) bytes.  Otherwise
    (serving) :func:`layer_slice` views."""
    if _training(tree):
        return _unbind(tree)[:n]
    return [layer_slice(tree, i) for i in range(n)]


def _remat(cfg, train: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in backward (activation
    checkpointing) when ``cfg.remat`` in a training forward: the
    reference's ``_maybe_ckpt``, which wraps each layer scan's body in
    ``jax.checkpoint`` when ``cfg.remat and not cache``.  A forward with
    a cache, or without grad, runs ``fn`` as it is."""
    if train and cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def paged_stacks(cache):
    """Every paged kv stack of a cache tree (the dicts holding a
    ``block_tables`` leaf), in tree order."""
    if L.is_paged(cache):
        return [cache]
    return [s for v in cache.values() if isinstance(v, dict)
            for s in paged_stacks(v)]


def copy_cache_blocks(cache, src, dst):
    """Copy-on-write fork over a whole paged cache: clone pool blocks
    ``src[i] -> dst[i]`` in place in every paged kv stack (k/v/pos
    together; the block table is untouched -- the allocator already
    rewrote the writer's entry)."""
    for st in paged_stacks(cache):
        L.cache_copy_blocks(st, src, dst)
    return cache


def copy_cache_block_rows(cache, src, dst, rows):
    """Partial-block tail copy over a whole paged cache: clone the first
    ``rows[i]`` token rows of pool block ``src[i]`` into ``dst[i]`` in
    every paged kv stack."""
    for st in paged_stacks(cache):
        L.cache_copy_block_rows(st, src, dst, rows)
    return cache


def _payload_tree(cache, fn):
    """Apply ``fn`` to every paged kv stack; returns the payload tree
    (the cache's structure, holding only the gathered stacks)."""
    if L.is_paged(cache):
        return fn(cache)
    return {k: _payload_tree(v, fn) for k, v in cache.items()
            if isinstance(v, dict)}


def peek_cache_blocks(cache, blocks):
    """Read-only gather over a whole paged cache: pool blocks
    ``blocks[i]`` (k/v/pos) of every paged kv stack, copied, without
    invalidating them.  Same payload structure as :func:`swap_out_blocks`
    (so :func:`swap_in_blocks` can restore it)."""
    return _payload_tree(cache, lambda st: L.cache_peek_blocks(st, blocks))


def swap_out_blocks(cache, blocks):
    """Host-swap gather over a whole paged cache: copy pool blocks
    ``blocks[i]`` out of every paged kv stack and invalidate their pool
    positions in place.  Returns ``(payload, cache)``."""
    payload = _payload_tree(
        cache, lambda st: L.cache_gather_blocks(st, blocks)[0])
    return payload, cache


def swap_in_blocks(cache, blocks, payload):
    """Host-swap scatter over a whole paged cache: restore a payload from
    :func:`swap_out_blocks` / :func:`peek_cache_blocks` into pool blocks
    ``blocks[i]`` of every paged kv stack, in place, bit-identical."""

    def walk(c, p):
        if L.is_paged(c):
            L.cache_scatter_blocks(c, blocks, p)
            return
        for k, v in c.items():
            if isinstance(v, dict):
                walk(v, p[k])

    walk(cache, payload)
    return cache


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _layer(cfg, p, h, pos, cache, *, window=0, ret_imp=False,
           write_index=None, ffn="mlp", mha=False):
    """One decoder layer; returns (h, cache, importance, aux loss: None
    for a dense FFN)."""
    a_in = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    a, nc, imp = L.attn_block(
        p["attn"], a_in, pos, cfg, cache, window=window,
        return_importance=ret_imp, n_heads=cfg.n_heads,
        n_kv=cfg.n_heads if mha else cfg.n_kv_heads, write_index=write_index)
    h = h + a
    f_in = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if ffn == "mlp":
        return h + L.mlp(p["mlp"], f_in), nc, imp, None
    # expert parallel under a ``moe_mesh`` hint; moe_ffn otherwise
    f, aux = L.moe_ffn_ep(p["moe"], f_in, top_k=cfg.top_k)
    return h + f, nc, imp, aux


def _write_index(positions, stack):
    """The write index of a dense or paged KV stack for ``positions``,
    computed once per forward and shared by every layer of the stack.
    The stack's K is (*layer axes, B, S, nkv, hd) dense, (*layer axes,
    nb, bs, nkv, hd) paged: S or the block size is its third axis from
    the end, whatever the number of layer axes."""
    if L.is_paged(stack):
        return L.paged_write_index(positions, stack["block_tables"],
                                   stack["k"].shape[-3])
    return L.cache_write_index(positions, stack["k"].shape[-3],
                               stack.get("slots"))


def _uniform_stack(cfg, params, h, positions, cache, *, window, ret_imp,
                   ffn):
    """The decoder stack over a dense or paged KV cache, every layer's FFN
    dense (``ffn="mlp"``) or MoE.  Returns (h, importance, summed aux)."""
    windex = (_write_index(positions, cache["layers"])
              if cache is not None else None)
    train = cache is None and _training(params)
    imps, aux = [], torch.zeros((), dtype=torch.float32, device=h.device)
    for i, lp in enumerate(layer_trees(params["layers"], cfg.n_layers)):
        lc = layer_slice(cache["layers"], i) if cache is not None else None
        h, _, imp, a = _remat(cfg, train, _layer, cfg, lp, h, positions, lc,
                              window=window, ret_imp=ret_imp,
                              write_index=windex, ffn=ffn)
        if a is not None:
            aux = aux + a
        if ret_imp:
            imps.append(imp)
    return h, torch.stack(imps).mean(0) if ret_imp else None, aux


def _moe_interleaved(cfg, params, h, positions, cache, *, window, ret_imp):
    """``moe_every`` > 1: each round runs one dense layer (``dense_layers``,
    its own KV stack ``cache["dense"]``), then one MoE layer
    (``moe_layers``, ``cache["moe"]``).  A round's importance is the mean
    of its two layers'; the result is the mean over rounds."""
    rounds = cfg.n_layers // cfg.moe_every
    windex = ({k: _write_index(positions, cache[k]) for k in ("dense", "moe")}
              if cache is not None else {"dense": None, "moe": None})
    train = cache is None and _training(params)
    lps = {k: layer_trees(params[k + "_layers"], rounds)
           for k in ("dense", "moe")}
    imps, aux = [], torch.zeros((), dtype=torch.float32, device=h.device)
    for r in range(rounds):
        rimps = []
        for stack, ffn in (("dense", "mlp"), ("moe", "moe")):
            lc = (layer_slice(cache[stack], r) if cache is not None
                  else None)
            h, _, imp, a = _remat(cfg, train, _layer, cfg, lps[stack][r], h,
                                  positions, lc, window=window,
                                  ret_imp=ret_imp,
                                  write_index=windex[stack], ffn=ffn)
            if a is not None:
                aux = aux + a
            rimps.append(imp)
        if ret_imp:
            imps.append((rimps[0] + rimps[1]) / 2)
    return h, torch.stack(imps).mean(0) if ret_imp else None, aux


def _ssm_backbone(cfg, params, h, cache, *, ret_imp):
    """The Mamba2 stack: residual blocks with no pre-norm, as the
    reference.  Positions play no part (the reference drops them)."""
    train = cache is None and _training(params)
    imps = []
    for i, lp in enumerate(layer_trees(params["layers"], cfg.n_layers)):
        lc = layer_slice(cache["layers"], i) if cache is not None else None
        h, imp = _remat(cfg, train, _mamba_residual, cfg, lp, h, lc,
                        ret_imp=ret_imp)
        if ret_imp:
            imps.append(imp)
    return h, torch.stack(imps).mean(0) if ret_imp else None


def _mamba_residual(cfg, p, h, cache, *, ret_imp):
    """``h`` plus one Mamba2 block (no pre-norm); returns (h,
    importance)."""
    out, _, imp = L.mamba_block(p, cfg, h, cache, return_importance=ret_imp)
    return h + out, imp


def _hybrid_backbone(cfg, params, h, positions, cache, *, window, ret_imp):
    """zamba2: each round runs ``attn_every`` Mamba2 residual blocks (no
    pre-norm), then the weight-shared MHA block (``n_kv = n_heads``) over
    that round's own KV cache.  A round's importance is the mean of its
    Mamba2 blocks' and the attention block's, halved; the result is the
    mean over rounds."""
    rounds = cfg.n_layers // cfg.attn_every
    windex = (_write_index(positions, cache["attn"])
              if cache is not None else None)
    shared = params["shared_attn"]
    train = cache is None and _training(params)
    imps = []
    for r, rp in enumerate(layer_trees(params["mamba_rounds"], rounds)):
        imps_m = []
        for i, lp in enumerate(layer_trees(rp, cfg.attn_every)):
            mc = (layer_slice(cache["mamba"], r, i) if cache is not None
                  else None)
            h, imp = _remat(cfg, train, _mamba_residual, cfg, lp, h, mc,
                            ret_imp=ret_imp)
            if ret_imp:
                imps_m.append(imp)
        ac = layer_slice(cache["attn"], r) if cache is not None else None
        h, _, imp_a, _ = _remat(cfg, train, _layer, cfg, shared, h,
                                positions, ac, window=window,
                                ret_imp=ret_imp, write_index=windex,
                                mha=True)
        if ret_imp:
            imps.append((torch.stack(imps_m).mean(0) + imp_a) / 2)
    return h, torch.stack(imps).mean(0) if ret_imp else None


def _cross_attn(cfg, p, x, kv_src=None, cross_cache=None):
    """Cross-attention of ``x`` (B, T, d) over ``kv_src`` (B, S, d) through
    the layer's own projections, or, without ``kv_src``, over the K/V
    already in ``cross_cache``.  No RoPE; every query sees every source
    token (positions all 0, non-causal), so under ``attn_impl="pallas"``
    it takes the plain path, as the reference's.  With both, the new K/V
    are written into ``cross_cache`` in place."""
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, T, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = shardctx.split_dim(q, -1, (nh, hd))
    if kv_src is not None:
        k = kv_src @ p["wk"]
        v = kv_src @ p["wv"]
        if "bk" in p:
            k = k + p["bk"]
            v = v + p["bv"]
        k = shardctx.split_dim(k, -1, (nkv, hd))
        v = shardctx.split_dim(v, -1, (nkv, hd))
        if cross_cache is not None:
            if cross_cache["k"].shape != k.shape:
                raise ValueError(
                    f"cross cache holds {tuple(cross_cache['k'].shape)}, "
                    f"the source gives {tuple(k.shape)}")
            cross_cache["k"].copy_(k)
            cross_cache["v"].copy_(v)
    else:
        k, v = cross_cache["k"], cross_cache["v"]
    qpos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    kvpos = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=x.device)
    out, _ = L.attention(q, k, v, qpos, kvpos, impl=cfg.attn_impl,
                         block_kv=cfg.attn_block_kv, causal=False)
    return L.row_parallel_out(shardctx.merge_heads(out) @ p["wo"])


def _cross_layer(cfg, p, h, kv_src, cross_cache):
    """The vlm's cross-attention layer: attention and FFN, each added
    through its tanh gate (computed in f32, as the reference)."""
    a_in = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    a = _cross_attn(cfg, p["attn"], a_in, kv_src, cross_cache)
    h = h + torch.tanh(p["gate_attn"].float()).to(h.dtype) * a
    f_in = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    f = L.mlp(p["mlp"], f_in)
    return h + torch.tanh(p["gate_ffn"].float()).to(h.dtype) * f


def _encdec_layer(cfg, p, h, pos, self_cache, kv_src, cross_cache, *,
                  window=0, ret_imp=False, write_index=None):
    """A whisper decoder layer: causal self-attention, cross-attention
    over the encoder's output, FFN.  Returns (h, importance)."""
    a_in = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    a, _, imp = L.attn_block(p["self_attn"], a_in, pos, cfg, self_cache,
                             window=window, return_importance=ret_imp,
                             write_index=write_index)
    h = h + a
    x_in = L.rms_norm(h, p["lnx"], cfg.norm_eps)
    h = h + _cross_attn(cfg, p["cross_attn"], x_in, kv_src, cross_cache)
    f_in = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + L.mlp(p["mlp"], f_in), imp


def _vlm_backbone(cfg, params, h, positions, cache, img_embeds, *, window,
                  ret_imp):
    """Each round runs ``cross_attn_every - 1`` dense self-attention
    layers, then one gated cross-attention layer over the projected image
    embeddings (or, without them, over the round's cross cache).  The
    importance is the mean over the self layers only."""
    kv_src = None
    if img_embeds is not None:
        kv_src = (img_embeds @ params["vision_proj"]).to(h.dtype)
    rounds = cfg.n_layers // cfg.cross_attn_every
    per = cfg.cross_attn_every - 1
    windex = (_write_index(positions, cache["self"])
              if cache is not None else None)
    train = cache is None and _training(params)
    cross = layer_trees(params["cross_layers"], rounds)
    imps = []
    for r, rp in enumerate(layer_trees(params["self_layers"], rounds)):
        for i, lp in enumerate(layer_trees(rp, per)):
            lc = (layer_slice(cache["self"], r, i) if cache is not None
                  else None)
            h, _, imp, _ = _remat(cfg, train, _layer, cfg, lp, h, positions,
                                  lc, window=window, ret_imp=ret_imp,
                                  write_index=windex)
            if ret_imp:
                imps.append(imp)
        cc = layer_slice(cache["cross"], r) if cache is not None else None
        h = _remat(cfg, train, _cross_layer, cfg, cross[r], h, kv_src, cc)
    return h, torch.stack(imps).mean(0) if ret_imp else None


def _encoder_layer(cfg, p, h, pos):
    """One non-causal self-attention layer of the audio encoder."""
    a_in = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    a, _, _ = L.attn_block(p["attn"], a_in, pos, cfg, None, causal=False)
    h = h + a
    f_in = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + L.mlp(p["mlp"], f_in)


def _audio_encoder(cfg, params, frames):
    """Non-causal self-attention layers over the audio frames (RoPE at
    positions ``0..Ta-1``), then ``enc_norm``.  It has no cache, so in a
    training forward each layer is recomputed in backward whenever
    ``cfg.remat``, as the reference's."""
    B, Ta, _ = frames.shape
    pos = torch.arange(Ta, dtype=torch.int32,
                       device=frames.device)[None].expand(B, Ta)
    train = _training(params)
    h = frames
    for lp in layer_trees(params["enc_layers"], cfg.n_encoder_layers):
        h = _remat(cfg, train, _encoder_layer, cfg, lp, h, pos)
    return L.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _audio_backbone(cfg, params, h, positions, cache, frames, *, window,
                    ret_imp):
    """The encoder runs once; its output feeds every decoder layer's
    cross-attention (each through that layer's own K/V projections).
    Without frames the decoder layers read their cross caches."""
    kv_src = (_audio_encoder(cfg, params, frames) if frames is not None
              else None)
    windex = (_write_index(positions, cache["self"])
              if cache is not None else None)
    train = cache is None and _training(params)
    imps = []
    for i, lp in enumerate(layer_trees(params["dec_layers"], cfg.n_layers)):
        sc, cc = ((layer_slice(cache["self"], i),
                   layer_slice(cache["cross"], i)) if cache is not None
                  else (None, None))
        h, imp = _remat(cfg, train, _encdec_layer, cfg, lp, h, positions, sc,
                        kv_src, cc, window=window, ret_imp=ret_imp,
                        write_index=windex)
        if ret_imp:
            imps.append(imp)
    return h, torch.stack(imps).mean(0) if ret_imp else None


def _aux_input(cfg, aux_inputs, cache):
    """The vlm's image embeds or the audio family's frames from
    ``aux_inputs`` (None when absent: the cross caches are read).  They
    come in the model's dtype (the reference's ``launch/specs.py``
    input contract); another dtype is refused, not cast."""
    key = AUX_INPUTS[cfg.family]
    x = (aux_inputs or {}).get(key)
    if x is None:
        if cache is None:
            raise ValueError(
                f"a {cfg.family} forward needs aux_inputs[{key!r}] or a "
                f"cache holding its cross K/V; got neither")
        return None
    if x.dtype != torch_dtype(cfg):
        raise ValueError(f"aux_inputs[{key!r}] is {x.dtype}; the model "
                         f"takes {torch_dtype(cfg)}")
    return x


def forward(cfg, params, tokens, positions, cache=None, aux_inputs=None, *,
            window: int = 0, return_importance: bool = False):
    """tokens: (B, T) int; positions: (B, T) int; ``aux_inputs``: the vlm's
    ``{"image_embeds": (B, n_image_tokens, vision_dim)}`` or the audio
    family's ``{"audio_frames": (B, n_audio_frames, d_model)}``, in the
    model's dtype (other families ignore it).

    Returns (logits (B, T, V), cache, importance or None, aux_loss):
    importance is (B, S) over the attention keys for the dense, moe, vlm
    and audio families (the self-attention keys),
    (B, T) per token for ssm and hybrid (the hybrid's attention keys are
    its tokens: without a cache, as in the reference, whose sum needs S
    = T).  ``cache`` is updated in place and returned (None without a
    cache).
    """
    _check_family(cfg)
    # on a mesh the residual stream is sharded over the batch axes and
    # replicated over "model" (a vocab-sharded lookup leaves a partial sum)
    h = shardctx.constrain_batch_dim(params["embed"][tokens], 0)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        h, imp = _ssm_backbone(cfg, params, h, cache,
                               ret_imp=return_importance)
    elif cfg.family == "hybrid":
        h, imp = _hybrid_backbone(cfg, params, h, positions, cache,
                                  window=window, ret_imp=return_importance)
    elif cfg.family == "vlm":
        h, imp = _vlm_backbone(cfg, params, h, positions, cache,
                               _aux_input(cfg, aux_inputs, cache),
                               window=window, ret_imp=return_importance)
    elif cfg.family == "audio":
        h, imp = _audio_backbone(cfg, params, h, positions, cache,
                                 _aux_input(cfg, aux_inputs, cache),
                                 window=window, ret_imp=return_importance)
    elif cfg.family == "moe" and cfg.moe_every > 1:
        h, imp, aux = _moe_interleaved(cfg, params, h, positions, cache,
                                       window=window,
                                       ret_imp=return_importance)
    else:
        h, imp, aux = _uniform_stack(
            cfg, params, h, positions, cache, window=window,
            ret_imp=return_importance,
            ffn="moe" if cfg.family == "moe" else "mlp")
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    unemb = (params["embed"].T if cfg.tie_embeddings else params["unembed"])
    logits = shardctx.constrain(h @ unemb, "logits")
    return logits, cache, imp, aux


def default_positions(batch: int, seq: int, *, device=None):
    dev = resolve_device(device)
    return torch.arange(seq, dtype=torch.int32, device=dev)[None].expand(
        batch, seq)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def _sharded_nll(logits, targets):
    """(B, T) ``logsumexp(logits) - logits[target]`` of DTensor logits as
    a ``local_map`` region: each rank takes its vocab slice's max,
    exp-sum and target hits (one logit plus zeros, exact), combined by
    all-reduces over the vocab's mesh axes.  Left to DTensor, the
    logsumexp gathers the whole vocab onto every rank and the gather's
    backward fills a zero tensor of the global logits' shape."""
    mesh = logits.device_mesh
    lp = tuple(p if p.is_shard() else Replicate() for p in logits.placements)
    vdims = [i for i, p in enumerate(lp) if p.is_shard(2)]
    vaxes = [mesh.mesh_dim_names[i] for i in vdims]
    tp = tuple(p if p.is_shard(0) else Replicate() for p in lp)

    def region(lg, tg):
        lf = lg.float()
        m = shardctx.pmax(lf.detach().amax(-1, keepdim=True), mesh, vaxes)
        s = shardctx.psum(torch.exp(lf - m).sum(-1, keepdim=True), mesh,
                          vaxes)
        v0 = shardctx.mesh_coord(mesh, vdims) * lg.shape[-1]
        vocab = torch.arange(v0, v0 + lg.shape[-1], device=lg.device)
        tgt = shardctx.psum(torch.where(vocab == tg[..., None], lg, 0).sum(
            -1, keepdim=True), mesh, vaxes)
        return (m + torch.log(s) - tgt.float())[..., 0]

    return local_map(region, out_placements=(tp,), in_placements=(lp, tp),
                     device_mesh=mesh, redistribute_inputs=True)(
        logits, shardctx.as_dtensor(targets, mesh))


def lm_loss(cfg, params, batch, *, aux_weight: float = 0.01):
    """Next-token cross-entropy plus ``aux_weight`` times the MoE
    load-balance loss.  ``batch``: ``{"tokens": (B, T) int}``, plus the
    vlm's ``"image_embeds"`` or the audio family's ``"audio_frames"``,
    passed to :func:`forward` as ``aux_inputs``.  The logsumexp runs on a
    float32 copy of the logits; the target logit is gathered in the
    logits' dtype, then cast, as the reference.  Returns (loss, {"nll",
    "aux"})."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    pos = default_positions(B, T, device=tokens.device)
    aux_inputs = {k: batch[k] for k in ("image_embeds", "audio_frames")
                  if k in batch}
    logits, _, _, aux = forward(cfg, params, tokens, pos,
                                aux_inputs=aux_inputs)
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    if isinstance(logits, DTensor):
        nll = _sharded_nll(logits, targets)
    else:
        lse = torch.logsumexp(logits.float(), dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        nll = lse - tgt.float()
    loss = nll.mean()
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}
