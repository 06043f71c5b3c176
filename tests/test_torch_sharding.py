"""The port's mesh tooling against the reference: sharding rules, input
specs, the cost counter, and dry runs of one train step on small meshes.

The reference's spec functions read only ``axis_size``, so they take a
stand-in mesh (``axis_names``, ``devices.shape``); the port's take a real
``DeviceMesh`` over a ``fake`` process group of as many ranks as the mesh
has (one process stands for rank 0).  ``logits_sharding`` builds a
``NamedSharding``, which needs a real jax mesh: the test swaps the
reference module's ``NamedSharding`` for one that returns its spec,
through ``monkeypatch``.
"""
from __future__ import annotations

import hashlib
import math
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Partial, Shard, distribute_tensor

import repro.configs as RC
from repro.launch import sharding as RSH
from repro.launch import specs as RSP
from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro.models.steps import make_train_step as ref_make_train_step
from repro.optim.adamw import AdamW as RefAdamW
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.mesh import (batch_axes, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.tree import flatten

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def ref_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes,
                           devices=SimpleNamespace(shape=shape))


def port_mesh(name):
    """A DeviceMesh of ``name`` under a fresh fake group (the caller is
    inside :func:`D.fake_world` of its size)."""
    shape, _ = MESHES[name]
    if name == "2x16x16":
        return make_production_mesh(multi_pod=True)
    if name == "16x16":
        return make_production_mesh()
    return make_host_mesh(data=shape[0], model=shape[1])


def ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): l
            for p, l in flat}


def port_flat(tree):
    return dict(flatten(tree))


def spec_tuple(spec):
    return tuple(spec)


def assert_same_leaves(port, ref):
    assert sorted(port) == sorted(ref)
    for path, leaf in port.items():
        r = ref[path]
        assert tuple(leaf.shape) == tuple(r.shape), path
        assert str(leaf.dtype).split(".")[-1] == str(r.dtype), path


@pytest.fixture(scope="module")
def ref_params():
    return {a: ref_flat(RSP.params_specs(RC.get_config(a)))
            for a in ASSIGNED_ARCHS}


# ---------------------------------------------------------------------------
# (a) sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_cache_batch_specs_match_reference(mesh_name, ref_params,
                                                 monkeypatch):
    monkeypatch.setattr(RSH, "NamedSharding", lambda mesh, spec: spec)
    rmesh = ref_mesh(mesh_name)
    with D.fake_world(math.prod(MESHES[mesh_name][0])):
        mesh = port_mesh(mesh_name)
        for arch in ASSIGNED_ARCHS:
            cfg, rcfg = get_config(arch), RC.get_config(arch)
            params = port_flat(SP.params_specs(cfg))
            for mode in ("train", "serve"):
                for fsdp in (True, False):
                    for path, leaf in params.items():
                        want = spec_tuple(RSH.param_spec(
                            path, ref_params[arch][path], rmesh, rcfg,
                            mode=mode, fsdp=fsdp))
                        got = SH.param_spec(path, leaf, mesh, cfg, mode=mode,
                                            fsdp=fsdp)
                        assert got == want, (arch, mode, fsdp, path)
            for shape in ("prefill_32k", "decode_32k", "long_500k",
                          "verify_32k"):
                spec = SP.input_specs(cfg, shape)
                rspec = RSP.input_specs(rcfg, shape)
                B = INPUT_SHAPES[shape].global_batch
                cache, rcache = port_flat(spec["cache"]), ref_flat(
                    rspec["cache"])
                total = sum(t.numel() * t.element_size()
                            for t in cache.values())
                rtotal = sum(l.size * l.dtype.itemsize
                             for l in rcache.values())
                assert total == rtotal
                for path, leaf in cache.items():
                    want = spec_tuple(RSH.cache_spec(
                        path, rcache[path], rmesh, rcfg, B,
                        total_bytes=rtotal))
                    assert SH.cache_spec(path, leaf, mesh, cfg, B,
                                         total_bytes=total) == want
            for B in (1, 4, 8, 16, 32, 128, 256, 512):
                assert SH.logits_spec(mesh, cfg, B) == spec_tuple(
                    RSH.logits_sharding(rmesh, rcfg, B))
        for B in (1, 2, 4, 8, 16, 32, 128, 256, 512):
            for nd in (1, 2, 3):
                assert SH.batch_spec(mesh, B, nd) == spec_tuple(
                    RSH.batch_spec(rmesh, B, nd))


def test_to_placements_layout():
    with D.fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert batch_axes(mesh) == ("pod", "data")
        assert SH.to_placements((("pod", "data"), None, "model"), mesh) == (
            Shard(0), Shard(0), Shard(2))
        with pytest.raises(ValueError):
            SH.to_placements((("data", "pod"),), mesh)
        # Shard(0) on pod then data: rank 0's rows are the first 1/32
        x = distribute_tensor(torch.empty(64, 3, device="meta"), mesh,
                              SH.to_placements((("pod", "data"), None), mesh))
        assert x.to_local().shape == (2, 3)


# ---------------------------------------------------------------------------
# (b) input specs, and the meta parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_and_param_specs_match_reference(arch, ref_params):
    cfg, rcfg = get_config(arch), RC.get_config(arch)
    t0 = time.perf_counter()
    params = SP.params_specs(cfg)
    assert time.perf_counter() - t0 < 10.0
    assert all(t.is_meta for t in port_flat(params).values())
    assert_same_leaves(port_flat(params), ref_params[arch])
    for shape in INPUT_SHAPES:
        got, want = SP.input_specs(cfg, shape), RSP.input_specs(rcfg, shape)
        assert_same_leaves(port_flat(got), ref_flat(want))
        if INPUT_SHAPES[shape].kind == "decode":
            assert SP.cache_len_for(cfg, shape) == RSP.cache_len_for(
                rcfg, shape)
            assert SP.decode_window_for(cfg, shape) == RSP.decode_window_for(
                rcfg, shape)


# digests of init_params(cfg.reduced(), 0, device="cpu"), taken from the
# code before the meta path was added
PARAM_DIGESTS = {
    "llama3.2-1b":
        "e120f7d565de034324c4b54e515c48e84c4743083e3eb9f263df0256a95d003a",
    "qwen3-moe-235b-a22b":
        "fda9f46ae92c99b955884110626193f8fe6957dec7ea7de8011120f50358d196",
    "mamba2-2.7b":
        "47a3ff488028298a63efca3dbde634332b2b847b02e012563cc1631a0b14c82b",
    "zamba2-2.7b":
        "f6e403dc9f8e4ce918ea5c48fd72d9fe63b8e6e1139472ccee69607963327650",
    "whisper-medium":
        "2fac23adaf27cabdc2d1a37bb56eef58904b06b18274b640438937fd8c3b1ea0",
    "llama-3.2-vision-90b":
        "1c24244d7af97c16409ae4ac7bbb545c00f8720de4844fd00697c5207d16052e",
    "llama4-maverick-400b-a17b":
        "2b51c058698ff23c0d19777339d6b641cb8c8c1881e0db016a41cd0fbe99fae6",
}


@pytest.mark.parametrize("arch", sorted(PARAM_DIGESTS))
def test_cpu_draws_unchanged(arch):
    h = hashlib.sha256()
    for path, leaf in flatten(M.init_params(get_config(arch).reduced(), 0,
                                            device="cpu")):
        h.update("/".join(path).encode())
        h.update(str(leaf.dtype).encode())
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == PARAM_DIGESTS[arch]


# ---------------------------------------------------------------------------
# (c) the cost counter
# ---------------------------------------------------------------------------

def test_cost_counts_each_iteration():
    a, b = torch.randn(8, 16), torch.randn(16, 16)

    def loop():
        y = None
        for _ in range(5):
            y = a @ b
        return y

    _, cost = analyze(loop)
    assert cost["flops"] == 5 * 2 * 8 * 16 * 16
    assert cost["unresolved_dots"] == 0


def test_cost_counts_per_device_share():
    with D.fake_world(8):
        mesh = make_host_mesh(data=2, model=4)
        x = torch.empty(16, 32, device="meta")
        w = torch.empty(32, 64, device="meta")
        # x's rows over data, w's columns over model: 1/8 a device
        xs = distribute_tensor(x, mesh, SH.to_placements(("data", None),
                                                         mesh))
        ws = distribute_tensor(w, mesh, SH.to_placements((None, "model"),
                                                         mesh))
        y, cost = analyze(lambda: xs @ ws)
        assert y.placements == (Shard(0), Shard(1))
        assert cost["flops"] == 2 * 16 * 32 * 64 / 8
        assert cost["collective_bytes"] == 0
        # the contraction over model: a Partial output, 1/4 a device
        xp = distribute_tensor(x, mesh, SH.to_placements((None, "model"),
                                                         mesh))
        wp = distribute_tensor(w, mesh, SH.to_placements(("model", None),
                                                         mesh))
        y, cost = analyze(lambda: xp @ wp)
        assert y.placements[1] == Partial()
        assert cost["flops"] == 2 * 16 * 32 * 64 / 4
        # its all-reduce: the (16, 64) f32 result
        y, cost = analyze(lambda: (xp @ wp).full_tensor())
        assert cost["collective_by_kind"] == {"all-reduce": 16 * 64 * 4}


# ---------------------------------------------------------------------------
# (d) dry runs of a reduced train step
# ---------------------------------------------------------------------------

REPRESENTATIVES = ["llama3.2-1b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
                   "zamba2-2.7b", "whisper-medium", "llama-3.2-vision-90b"]
TRAIN_SMALL = InputShape("train_small", 64, 4, "train")


def reduced(cfg):
    return cfg.reduced().replace(dtype="bfloat16", remat=True)


def ref_train_avals(rcfg):
    B, T = TRAIN_SMALL.global_batch, TRAIN_SMALL.seq_len
    p = RSP.params_specs(rcfg)
    o = jax.eval_shape(RefAdamW().init, p)
    batch = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32),
             **RSP.aux_specs(rcfg, B)}
    return p, o, batch


def local_bytes(aval, spec, rmesh):
    ways = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                ways *= dict(zip(rmesh.axis_names, rmesh.devices.shape))[a]
    return aval.size * aval.dtype.itemsize // ways


def ref_argument_bytes(rcfg, rmesh):
    """The train step's argument bytes a device holds, from the
    reference's own spec functions."""
    p, o, batch = ref_train_avals(rcfg)
    total = 0
    for tree in (p, o.mu, o.nu):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        total += sum(local_bytes(l, RSH.param_spec(path, l, rmesh, rcfg,
                                                   mode="train"), rmesh)
                     for path, l in flat)
    total += o.step.size * o.step.dtype.itemsize
    total += sum(local_bytes(l, RSH.batch_spec(rmesh, l.shape[0],
                                               len(l.shape)), rmesh)
                 for l in jax.tree.leaves(batch))
    return total


@pytest.mark.parametrize("arch", REPRESENTATIVES)
def test_reduced_train_dry_run_on_2x4(arch):
    with D.fake_world(8):
        mesh = make_host_mesh(data=2, model=4)
        rec = D.trace_record(reduced(get_config(arch)), TRAIN_SMALL, mesh)
    assert rec["ok"] and rec["flops_per_dev"] > 0
    assert rec["unresolved_dots"] == 0
    assert rec["memory"]["argument_bytes"] == ref_argument_bytes(
        reduced(RC.get_config(arch)), ref_mesh("2x4"))
    assert set(rec["collective_by_kind"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b"])
def test_1x1_flops_match_hlo_analysis(arch):
    with D.fake_world(1):
        mesh = make_host_mesh()
        rec = D.trace_record(reduced(get_config(arch)), TRAIN_SMALL, mesh)
    rcfg = reduced(RC.get_config(arch))
    p, o, batch = ref_train_avals(rcfg)
    hlo = jax.jit(ref_make_train_step(rcfg, RefAdamW())).lower(
        p, o, batch).compile().as_text()
    ref = hlo_analyze(hlo)["flops"]
    assert abs(rec["flops_per_dev"] - ref) <= 0.02 * ref, (
        rec["flops_per_dev"], ref)


def test_moe_ffn_refuses_a_shape_only_trace():
    """moe_ffn no longer refuses a shape-only trace (ROADMAP P3, fixed;
    the name is kept from when it did): it keeps its group offsets on the
    device, where grouped_mm reads them, so a meta trace needs no values
    and gives the output's shape and dtype and a scalar f32 aux (the dry
    run's moe long_500k cells)."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    p = {k: v[0] for k, v in SP.params_specs(cfg)["layers"]["moe"].items()}
    x = torch.empty(1, 4, cfg.d_model, dtype=torch.bfloat16, device="meta")
    out, aux = L.moe_ffn(p, x, top_k=cfg.top_k)
    assert out.shape == x.shape and out.dtype == x.dtype and out.is_meta
    assert aux.shape == () and aux.dtype == torch.float32
