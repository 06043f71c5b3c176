"""Optional sharding hints for model internals (port of
``repro/models/shardctx.py``).

The model code is mesh-agnostic.  A launcher (the dry run) installs
DTensor placements here, and :func:`constrain` redistributes a DTensor to
them where sharding propagation would otherwise go wrong (the (B, T, V)
logits: without the hint the unembedding is replicated across the model
axis).  A plain tensor, or a name with no hint, is returned as it is, so
the served path (plain tensors, no hint) is untouched.

Hints: ``logits`` (placements), ``mesh_batch_axes`` ((mesh, batch axis
names)), ``moe_mesh`` ((mesh, batch axis names), read by
``layers.moe_ffn_ep``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

_HINTS: dict = {}


def set_hints(**hints):
    _HINTS.update({k: v for k, v in hints.items() if v is not None})


def clear_hints():
    _HINTS.clear()


@contextlib.contextmanager
def hints(**kw):
    old = dict(_HINTS)
    set_hints(**kw)
    try:
        yield
    finally:
        _HINTS.clear()
        _HINTS.update(old)


def get(name: str):
    return _HINTS.get(name)


def as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor is taken as the
    global tensor, replicated on every rank."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def mesh_coord(mesh, dims) -> int:
    """This rank's index along the mesh dims ``dims`` taken together, the
    first major."""
    r = 0
    for i in dims:
        r = r * mesh.shape[i] + mesh.get_local_rank(i)
    return r


class _AllReduceSum(torch.autograd.Function):
    """``lax.psum`` over one mesh dim: the sum of every rank's tensor.
    Its result is replicated over the dim, so each rank's gradient is the
    (equal) cotangent itself."""

    @staticmethod
    def forward(ctx, x, group):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x, mesh, axes):
    """The sum of a local tensor over the ranks of the mesh axes ``axes``
    (inside a ``local_map`` region), differentiable."""
    for a in axes:
        x = _AllReduceSum.apply(x, (mesh, mesh.mesh_dim_names.index(a)))
    return x


class _SumGrad(torch.autograd.Function):
    """``lax.pvary`` over one mesh dim: ``x`` itself, taken from here on
    as varying over the dim; its gradient is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_reduce(g, "sum", ctx.group)), None


def pvary(x, mesh, axes):
    """A tensor that is the same on every rank of the mesh axes ``axes``
    (inside a ``local_map`` region), as it enters a computation that
    differs between those ranks.  ``local_map`` takes a replicated
    input's gradient to be replicated too: without this each rank keeps
    only the share of the gradient its own computation made."""
    for a in axes:
        x = _SumGrad.apply(x, (mesh, mesh.mesh_dim_names.index(a)))
    return x


def pmax(x, mesh, axes):
    """The elementwise max of a local tensor over the ranks of ``axes``
    (no gradient)."""
    for a in axes:
        x = funcol.wait_tensor(funcol.all_reduce(
            x, "max", (mesh, mesh.mesh_dim_names.index(a))))
    return x


def _redistribute(x, placements):
    """``x`` in ``placements``, through a redistribution even when it is
    there already: the redistribution's backward lays the gradient out as
    ``x`` was, so a hint pins the gradient too."""
    return x.redistribute(x.device_mesh, placements)


def constrain(x, name: str):
    h = _HINTS.get(name)
    if h is None or not isinstance(x, DTensor):
        return x
    return _redistribute(x, h)


def constrain_batch_dim(x, dim: int):
    """Shard axis ``dim`` of a DTensor over the batch axes and replicate
    everything else (a no-op where the axis does not divide).  Used
    where propagation goes wrong: the residual stream (a partial sum left
    there makes every later product run replicated over "model"), the
    blocked attention's K/V and the SSM scan (the sequence they cut into
    blocks must not be sharded), the MoE dispatch, and each micro-batch
    of a train step."""
    h = _HINTS.get("mesh_batch_axes")
    if h is None or not isinstance(x, DTensor):
        return x
    mesh, axes = h
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    total = 1
    for a in axes:
        total *= sizes[a]
    if x.shape[dim] % total != 0 or x.shape[dim] < total:
        return x
    return _redistribute(x, tuple(
        Shard(dim % x.ndim) if a in axes else Replicate()
        for a in mesh.mesh_dim_names))


def split_dim(x, dim: int, sizes):
    """``x`` with axis ``dim`` split into ``sizes`` (a reshape).  A
    DTensor sharded on that axis over mesh dims that do not divide
    ``sizes[0]`` cannot be split so (DTensor keeps a split axis's shards
    on its first part; here a shard would fall within one): those mesh
    dims are gathered first (an all-gather of this tensor alone), the
    others keep their shards.  A plain tensor is only reshaped."""
    dim %= x.ndim
    if isinstance(x, DTensor):
        ways = 1
        for p, s in zip(x.placements, x.device_mesh.shape):
            if p.is_shard(dim):
                ways *= s
        if sizes[0] % ways:
            x = _redistribute(x, tuple(Replicate() if p.is_shard(dim) else p
                                       for p in x.placements))
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def merge_heads(x):
    """(.., n, hd) heads as one (.., n * hd) dim.  For a DTensor the
    result goes through a redistribution to its own layout, so its
    gradient comes back laid out as the forward output was, which the
    reshape's backward can split into heads again (a gradient sharded
    over more ranks than there are heads cannot be)."""
    x = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _redistribute(x, x.placements) if isinstance(x, DTensor) else x
