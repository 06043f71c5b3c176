"""The expert-parallel MoE (``layers.moe_ffn_ep``) against the reference.

The port runs on 8 gloo ranks (a 2 x 4 ("data", "model") mesh, spawned
processes over a ``FileStore``, so no port is opened); the reference runs
its ``shard_map`` region on a 2 x 4 mesh of forced host devices in a
subprocess (jax fixes the device count when it starts).  Both take the
same float32 parameters and input, with a capacity that drops
assignments, and the gradients of ``sum(out * cot) + aux`` (``cot`` a
fixed random cotangent) with respect to the input and every parameter
are held against ``jax.grad`` of the same.  Without a ``moe_mesh`` hint
the port's ``moe_ffn_ep`` is ``moe_ffn``, bit for bit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import shardctx
from repro_torch.tree import tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8                       # the 2 x 4 mesh

REF_SNIPPET = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro.launch.mesh import batch_axes, make_host_mesh
    from repro.models import layers as L, shardctx
    d = dict(np.load(sys.argv[1]))
    top_k, cf = int(d.pop("top_k")), float(d.pop("cf"))
    x, cot = jnp.asarray(d.pop("x")), jnp.asarray(d.pop("cot"))
    p = {k: jnp.asarray(v) for k, v in d.items() if not k.startswith("s_")}
    if "s_w_gate" in d:
        p["shared"] = {k[2:]: jnp.asarray(v) for k, v in d.items()
                       if k.startswith("s_")}
    mesh = make_host_mesh(data=2, model=4)
    def loss(p, x):
        out, aux = L.moe_ffn_ep(p, x, top_k=top_k, capacity_factor=cf)
        return (out * cot).sum() + aux
    with shardctx.hints(moe_mesh=(mesh, batch_axes(mesh))):
        out, aux = jax.jit(lambda p, x: L.moe_ffn_ep(
            p, x, top_k=top_k, capacity_factor=cf))(p, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    gp = dict(gp, **{"s_" + k: v for k, v in gp.pop("shared", {}).items()})
    np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(aux),
             g_x=np.asarray(gx),
             **{"g_" + k: np.asarray(v) for k, v in gp.items()})
""")

# (B, T, d, dff, E, top_k, capacity factor, router skew, shared expert):
# "drop_c" keeps C = 8 of a rank's 32 assignments (cf 0.5, Ce = C);
# "drop_ce" has C = 512 > 256, so Ce = C / E_loc = 128 rows of a
# token-rank's 256, and a router skewed to expert 0 overflows its bucket.
CASES = {
    "drop_c": (4, 8, 16, 32, 8, 2, 0.5, 0.0, False),
    "drop_ce": (4, 128, 16, 24, 16, 2, 4.0, 3.0, True),
}


def make_inputs(case, seed=0):
    B, T, d, dff, E, k, cf, skew, shared = CASES[case]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    inp = {
        "x": rng.standard_normal((B, T, d)).astype(f32),
        "router": (rng.standard_normal((d, E)) / np.sqrt(d)).astype(f32),
        "w_gate": (rng.standard_normal((E, d, dff)) / np.sqrt(d)).astype(f32),
        "w_up": (rng.standard_normal((E, d, dff)) / np.sqrt(d)).astype(f32),
        "w_down": (rng.standard_normal((E, dff, d))
                   / np.sqrt(dff)).astype(f32),
    }
    inp["router"][:, 0] += skew * np.sign(inp["x"].mean((0, 1)))
    if shared:
        for name, shape in (("w_gate", (d, dff)), ("w_up", (d, dff)),
                            ("w_down", (dff, d))):
            inp["s_" + name] = (rng.standard_normal(shape)
                                / np.sqrt(shape[0])).astype(f32)
    inp["cot"] = rng.standard_normal((B, T, d)).astype(f32)
    return inp, k, cf


def torch_params(inp):
    p = {k: torch.from_numpy(v) for k, v in inp.items()
         if k not in ("x", "cot") and not k.startswith("s_")}
    if "s_w_gate" in inp:
        p["shared"] = {k[2:]: torch.from_numpy(v) for k, v in inp.items()
                       if k.startswith("s_")}
    return p


def _grads(p, x, cot, k, cf):
    """(out, aux, {"g_x", "g_<param>", "g_s_<shared param>"}) of one call
    of ``moe_ffn_ep``, the gradients of ``sum(out * cot) + aux``."""
    leaves = {"x": x, **{n: t for n, t in p.items() if n != "shared"},
              **{"s_" + n: t for n, t in p.get("shared", {}).items()}}
    for t in leaves.values():
        t.requires_grad_()
    out, aux = L.moe_ffn_ep(p, x, top_k=k, capacity_factor=cf)
    g = torch.autograd.grad((out * cot).sum() + aux, list(leaves.values()))
    full = (lambda t: t.full_tensor() if isinstance(t, DTensor) else t)
    return (full(out).detach(), full(aux).detach(),
            {"g_" + n: full(t) for n, t in zip(leaves, g)})


def _worker(rank, store_path, case, out_path):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        torch.set_num_threads(1)
        mesh = make_host_mesh(data=2, model=4, device_type="cpu")
        inp, k, cf = make_inputs(case)
        x, cot = torch.from_numpy(inp["x"]), torch.from_numpy(inp["cot"])
        p = torch_params(inp)
        res = {}
        with shardctx.hints(moe_mesh=(mesh, batch_axes(mesh))):
            # plain tensors: taken as the global tensors on every rank
            out, aux, g = _grads(tree_map(torch.clone, p), x.clone(), cot,
                                 k, cf)
            res.update(out=out, aux=aux, **g)
            # DTensors laid out by the sharding rules (train mode, FSDP)
            shard = SH.params_shardings(mesh, None, {"moe": p})["moe"]
            pd = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl),
                          p, shard)
            b_pl = SH.batch_shardings(mesh, {"x": x})["x"]
            out, aux, g = _grads(pd, distribute_tensor(x, mesh, b_pl),
                                 distribute_tensor(cot, mesh, b_pl), k, cf)
            res.update(out_d=out, aux_d=aux,
                       **{n + "_d": t for n, t in g.items()})
        if rank == 0:
            np.savez(out_path, **{n: t.numpy() for n, t in res.items()})
    finally:
        dist.destroy_process_group()


def run_reference(inp, k, cf, tmp_path):
    src, dst = tmp_path / "ref_in.npz", tmp_path / "ref_out.npz"
    np.savez(src, top_k=k, cf=cf, **inp)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REF_SNIPPET, str(src),
                          str(dst)], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return np.load(dst)


def drops(case) -> bool:
    """True when the capacity drops an assignment on some rank: the
    count of kept assignments is recomputed from the routing alone."""
    B, T, d, _, E, k, cf, _, _ = CASES[case]
    inp, _, _ = make_inputs(case)
    x = torch.from_numpy(inp["x"]).reshape(2, B // 2 * T, d)
    msz, E_loc = 4, E // 4
    N_loc = x.shape[1]
    C = min(-(-max(int(N_loc * k / msz * cf), 8) // 8) * 8, N_loc * k)
    Ce = C if C <= 256 else max(C // E_loc, 8)
    for xl in x:
        _, _, top_e = L.moe_route(torch.from_numpy(inp["router"]), xl, k)
        for r in range(msz):
            owned = top_e[(top_e // E_loc) == r] - r * E_loc
            kept = torch.sort(owned).values[:C]
            if len(owned) > C or torch.bincount(kept).max() > Ce:
                return True
    return False


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    """(case, the reference's result, the port's) on 2 x 4."""
    case = request.param
    tmp = tmp_path_factory.mktemp(case)
    inp, k, cf = make_inputs(case)
    ref = run_reference(inp, k, cf, tmp)
    out_path = tmp / "port.npz"
    mp.spawn(_worker, args=(str(tmp / "store"), case, str(out_path)),
             nprocs=WORLD, join=True)
    return case, ref, np.load(out_path)


def test_moe_ffn_ep_matches_reference_on_2x4(runs):
    case, ref, port = runs
    assert drops(case)
    for o, a in (("out", "aux"), ("out_d", "aux_d")):
        np.testing.assert_allclose(port[o], ref["out"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(port[a], ref["aux"], atol=1e-6, rtol=0)


def test_moe_ffn_ep_grads_match_reference_on_2x4(runs):
    _, ref, port = runs
    names = [n for n in ref.files if n.startswith("g_")]
    assert "g_x" in names and "g_router" in names and "g_w_down" in names
    # (sums of up to 512 float32 terms, some of magnitude ~40)
    for n in names:
        for route in (n, n + "_d"):
            np.testing.assert_allclose(port[route], ref[n], atol=1e-5,
                                       rtol=1e-5, err_msg=route)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_ep_without_hint_is_moe_ffn(case):
    inp, k, cf = make_inputs(case)
    x, p = torch.from_numpy(inp["x"]), torch_params(inp)
    assert shardctx.get("moe_mesh") is None
    out, aux = L.moe_ffn_ep(p, x, top_k=k, capacity_factor=cf)
    ref_out, ref_aux = L.moe_ffn(p, x, top_k=k)
    assert torch.equal(out, ref_out) and torch.equal(aux, ref_aux)
