"""The model's DTensor branches on a real 2 x 4 mesh, against the plain
CPU path of the same parameters and inputs.

Eight gloo ranks (spawned processes over a ``FileStore``, so no port is
opened) form the ("data", "model") mesh.  Reduced configs in float32,
laid out by the sharding rules with the dry run's hints installed, take

  * a forward, ``lm_loss`` and its gradients (train mode, FSDP): the
    sharded attention with 4 query heads over 4 model ranks and 2 KV
    heads (each rank's one query head reads a slice of the gathered KV
    heads), ``split_dim`` / ``merge_heads`` / ``row_parallel_out``, the
    vocab-sharded unembedding and the vocab-parallel loss;
  * one decode step (serve mode, naive attention, as the dry run) into a
    cache whose sequence dim is sharded over "model" (the threshold set
    to 0), each row's new token landing on another model rank's slice.

Every value is held against the plain path within 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import shardctx
from repro_torch.models.steps import make_decode_step
from repro_torch.tree import flatten, tree_map

WORLD = 8                        # the 2 x 4 mesh
TOL = 1e-5
B, T = 4, 16                     # train batch
S = 32                           # decode cache: 8 slots per model rank
DECODE_POS = (3, 9, 17, 30)      # each row's new token: model ranks 0-3


def tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, shape))


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _dist(tree, placements, mesh):
    return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), tree,
                    placements)


def _hints(mesh, cfg, batch):
    return shardctx.hints(logits=SH.logits_sharding(mesh, cfg, batch),
                          mesh_batch_axes=(mesh, batch_axes(mesh)))


def train_grads(cfg, params, toks):
    leaves = [t.requires_grad_() for _, t in flatten(params)]
    loss, _ = M.lm_loss(cfg, params, {"tokens": toks})
    grads = torch.autograd.grad(loss, leaves)
    return _full(loss), [_full(g) for g in grads]


def _worker(rank, store_path, arch, out_path):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        torch.set_num_threads(1)
        mesh = make_host_mesh(data=2, model=4, device_type="cpu")
        cfg = get_config(arch).reduced()
        out = {}

        # forward, lm_loss and its gradients
        params = M.init_params(cfg, 0, device="cpu")
        toks = tokens(cfg, (B, T), 1)
        loss, grads = train_grads(cfg, tree_map(torch.clone, params), toks)
        pd = _dist(params, SH.params_shardings(mesh, cfg, params), mesh)
        td = distribute_tensor(toks, mesh, SH.batch_shardings(mesh, toks))
        with _hints(mesh, cfg, B), implicit_replication():
            loss_d, grads_d = train_grads(cfg, pd, td)
        out["loss"], out["loss_d"] = loss.detach(), loss_d.detach()
        for i, (g, gd) in enumerate(zip(grads, grads_d)):
            out[f"grad{i}"], out[f"grad{i}_d"] = g, gd

        # one decode step into a cache whose sequence is sharded
        dcfg = cfg.replace(attn_impl="naive")
        cache = M.init_cache(dcfg, B, S, device="cpu")
        n = max(DECODE_POS)
        pos = torch.arange(n).repeat(B, 1)
        pos = torch.where(pos < torch.tensor(DECODE_POS)[:, None], pos, -1)
        with torch.no_grad():
            M.forward(dcfg, params, tokens(cfg, (B, n), 2), pos, cache=cache)
        old = SH._SEQ_SHARD_THRESHOLD
        SH._SEQ_SHARD_THRESHOLD = 0
        try:
            c_pl = SH.cache_shardings(mesh, dcfg, cache, B)
        finally:
            SH._SEQ_SHARD_THRESHOLD = old
        cd = _dist(cache, c_pl, mesh)
        p_serve = _dist(params, SH.params_shardings(mesh, dcfg, params,
                                                    mode="serve"), mesh)
        tok = tokens(cfg, (B, 1), 3)
        dpos = torch.tensor(DECODE_POS, dtype=torch.int32)[:, None]
        step = make_decode_step(dcfg)
        with torch.no_grad():
            logits, cache = step(params, cache, tok, dpos)
            with _hints(mesh, dcfg, B), implicit_replication():
                logits_d, cd = step(
                    p_serve, cd,
                    *(distribute_tensor(t, mesh, SH.batch_shardings(mesh, t))
                      for t in (tok, dpos)))
        out["logits"], out["logits_d"] = logits, _full(logits_d)
        out["seq_sharded"] = np.array([any(
            p.is_shard(1) for p in t.placements)
            for path, t in flatten(cd) if path[-1] in ("k", "v")])
        for path, t in flatten(cache):
            key = "cache_" + "/".join(map(str, path))
            out[key], out[key + "_d"] = t, _full(flatten_get(cd, path))
        if rank == 0:
            np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def flatten_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module", params=["llama3.2-1b", "mamba2-2.7b"])
def mesh_run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param.replace(".", "_"))
    out_path = tmp / "port.npz"
    mp.spawn(_worker, args=(str(tmp / "store"), request.param,
                            str(out_path)), nprocs=WORLD, join=True)
    return request.param, dict(np.load(out_path))


def test_forward_loss_grads_on_2x4(mesh_run):
    _, r = mesh_run
    np.testing.assert_allclose(r["loss_d"], r["loss"], atol=TOL, rtol=0)
    n = sum(k.startswith("grad") and not k.endswith("_d") for k in r)
    assert n > 0
    for i in range(n):
        np.testing.assert_allclose(r[f"grad{i}_d"], r[f"grad{i}"], atol=TOL,
                                   rtol=0, err_msg=f"grad {i}")


def test_decode_into_sharded_cache_on_2x4(mesh_run):
    arch, r = mesh_run
    if arch == "llama3.2-1b":
        assert r["seq_sharded"].all()   # the KV cache's S over "model"
    np.testing.assert_allclose(r["logits_d"], r["logits"], atol=TOL, rtol=0)
    keys = [k for k in r if k.startswith("cache_") and not k.endswith("_d")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(r[k + "_d"], r[k], atol=TOL, rtol=0,
                                   err_msg=k)
