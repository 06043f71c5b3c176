"""Sharding rules (port of ``repro/launch/sharding.py``): the
reference's parameter, cache and batch specs, and their DTensor
placements.

A *spec* is the reference's ``PartitionSpec`` as a plain tuple, one entry
per tensor dim: ``None`` (replicated), an axis name, or a tuple of axis
names (that dim sharded over several mesh axes, the first major).
:func:`to_placements` turns a spec into DTensor placements, one per mesh
dim.  The rules are the reference's, unchanged:

* tensor parallel over "model": attention head projections, FFN hidden,
  the MoE expert dim (expert parallel), vocab;
* FSDP over "data" in train mode: the non-model-sharded major dim of
  every large matrix;
* batch over ("pod", "data") when divisible; "pod" is pure data parallel.

Every rule checks divisibility and replicates otherwise.  Serving KV
caches shard the sequence dim over "model" only when the batch-sharded
cache would pass :data:`_SEQ_SHARD_THRESHOLD` bytes a device.  ``serve``
mode drops FSDP on parameters, except the MoE expert banks, which stay
sharded over ("data" x "model").
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_size, batch_axes
from repro_torch.tree import flatten, unflatten


def _div(n: int, size: int) -> bool:
    return size > 1 and n % size == 0 and n >= size


def param_spec(path, leaf, mesh, cfg, *, mode: str = "train",
               fsdp: bool = True) -> tuple:
    """Spec of one parameter leaf; ``path`` is its tuple of keys."""
    msz = axis_size(mesh, "model")
    dsz = axis_size(mesh, "data")
    names = [str(p) for p in path]
    name = names[-1]
    shape = leaf.shape
    nd = len(shape)
    spec = [None] * nd
    want_fsdp = fsdp and mode == "train"

    def set_trailing(model_dim_offset, data_dim_offset):
        """Negative offsets from the end of the model and data dims."""
        mi = nd + model_dim_offset
        di = nd + data_dim_offset
        if mi >= 0 and _div(shape[mi], msz):
            spec[mi] = "model"
        if want_fsdp and di >= 0 and spec[di] is None and _div(shape[di], dsz):
            spec[di] = "data"

    is_moe_expert = ("moe" in names and "shared" not in names
                     and name in ("w_gate", "w_up", "w_down"))

    if name in ("wq", "wk", "wv"):
        set_trailing(-1, -2)   # (.., d, heads*hd): heads over model
    elif name == "wo":
        set_trailing(-2, -1)   # (.., heads*hd, d): the contraction dim
    elif is_moe_expert:
        # (.., E, d, dff) / (.., E, dff, d): experts over "model", the
        # expert d over "data" (gathered per layer in moe_ffn_ep)
        if _div(shape[-3], msz):
            spec[-3] = "model"
        di = nd - 1 if name == "w_down" else nd - 2
        if _div(shape[di], dsz):
            spec[di] = "data"
    elif name in ("w_gate", "w_up"):
        set_trailing(-1, -2)   # (.., d, dff): dff over model
    elif name == "w_down":
        set_trailing(-2, -1)   # (.., dff, d): dff over model
    elif name == "router":
        if want_fsdp and _div(shape[-2], dsz):
            spec[-2] = "data"
    elif name == "embed":
        if _div(shape[0], msz):
            spec[0] = "model"
        if want_fsdp and _div(shape[1], dsz):
            spec[1] = "data"
    elif name in ("unembed", "vision_proj", "in_proj"):
        set_trailing(-1, -2)   # (d, V) / (vision_dim, d) / mamba (d, ...)
    elif name == "out_proj":
        set_trailing(-2, -1)   # mamba (di, d)
    elif name in ("conv_w", "bq", "bk", "bv"):
        if _div(shape[-1], msz):
            spec[-1] = "model"
    # norms, gates, A_log, D, dt_bias, conv_b, gate_norm: replicated
    return tuple(spec)


_SEQ_SHARD_THRESHOLD = 8 << 30  # bytes/device above which S must shard


def cache_spec(path, leaf, mesh, cfg, batch: int, *,
               total_bytes: int = 0) -> tuple:
    """Spec of one cache leaf (leading layer/round axes never sharded):

      k/v:   (..., B, S, nkv, hd)  -> B over data; S over model only when
                                      the batch-sharded cache passes
                                      ``_SEQ_SHARD_THRESHOLD`` a device
      pos:   (..., B, S)           -> follows k/v
      state: (..., B, H, Pd, N)    -> B over data, H over model
      conv:  (..., B, W-1, C)      -> B over data, C over model
    """
    dsz = axis_size(mesh, "data")
    msz = axis_size(mesh, "model")
    name = str(path[-1])
    shape = leaf.shape
    nd = len(shape)
    spec = [None] * nd
    if name in ("k", "v", "state"):
        bi, si = nd - 4, nd - 3
    elif name == "pos":
        bi, si = nd - 2, nd - 1
    elif name == "conv":
        bi, si = nd - 3, nd - 1
    else:
        return tuple(spec)
    b_sharded = _div(shape[bi], dsz)
    if b_sharded:
        spec[bi] = "data"
    if name in ("k", "v", "pos"):
        per_dev = total_bytes // (dsz if b_sharded else 1)
        if per_dev > _SEQ_SHARD_THRESHOLD and _div(shape[si], msz):
            spec[si] = "model"
    elif _div(shape[si], msz):
        spec[si] = "model"
    return tuple(spec)


def batch_spec(mesh, batch: int, nd: int) -> tuple:
    """Shard the leading batch dim over as many data axes as divide it."""
    axes = batch_axes(mesh)
    total = 1
    for a in axes:
        total *= axis_size(mesh, a)
    spec = [None] * nd
    if batch % total == 0 and batch >= total:
        spec[0] = tuple(axes) if len(axes) > 1 else axes[0]
    elif (batch % axis_size(mesh, "data") == 0
          and batch >= axis_size(mesh, "data")):
        spec[0] = "data"
    return tuple(spec)


def logits_spec(mesh, cfg, batch: int) -> tuple:
    """(B, T, V) logits: batch over the data axes, vocab over model."""
    vdim = "model" if _div(cfg.vocab, axis_size(mesh, "model")) else None
    return (batch_spec(mesh, batch, 3)[0], None, vdim)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a spec.  A dim sharded
    over several axes takes ``Shard(d)`` on each of their mesh dims; the
    mesh order makes the first axis major, as ``P(("pod", "data"))``."""
    place = [Replicate()] * mesh.ndim
    dims = list(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [dims.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order")
        for i in idx:
            place[i] = Shard(d)
    return tuple(place)


def logits_sharding(mesh, cfg, batch: int) -> tuple:
    """The logits' placements, installed as the ``logits`` hint
    (:mod:`repro_torch.models.shardctx`): without it the unembedding is
    replicated across the model axis."""
    return to_placements(logits_spec(mesh, cfg, batch), mesh)


def params_shardings(mesh, cfg, params, *, mode: str = "train",
                     fsdp: bool = True) -> dict:
    """The placements of every parameter leaf, as a tree of ``params``'
    structure."""
    flat = flatten(params)
    return unflatten([p for p, _ in flat],
                     [to_placements(param_spec(p, leaf, mesh, cfg, mode=mode,
                                               fsdp=fsdp), mesh)
                      for p, leaf in flat])


def cache_shardings(mesh, cfg, cache, batch: int) -> dict:
    flat = flatten(cache)
    total = sum(leaf.numel() * leaf.element_size() for _, leaf in flat)
    return unflatten([p for p, _ in flat],
                     [to_placements(cache_spec(p, leaf, mesh, cfg, batch,
                                               total_bytes=total), mesh)
                      for p, leaf in flat])


def batch_shardings(mesh, tree):
    """Batch placements of a tree of batch-major tensors, or of one."""
    if not isinstance(tree, dict):
        return to_placements(batch_spec(mesh, tree.shape[0], tree.ndim), mesh)
    flat = flatten(tree)
    return unflatten([p for p, _ in flat],
                     [to_placements(batch_spec(mesh, leaf.shape[0],
                                               leaf.ndim), mesh)
                      for _, leaf in flat])
