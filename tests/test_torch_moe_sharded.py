"""``moe_ffn`` over DTensors (``layers._moe_ffn_sharded``) against the
reference's ``moe_ffn`` and ``jax.grad``.

``moe_ffn_ep`` hands a batch the data axes do not divide (the dry run's
B = 1 ``long_500k``), or experts the "model" axis does not divide, to
``moe_ffn``; over DTensors that runs as a ``local_map`` region in which
each model rank takes every assignment to its own experts through
``grouped_mm`` and one all-reduce over "model" sums them -- no capacity,
nothing dropped.  The port runs on 8 gloo ranks as a 2 x 4 ("data",
"model") mesh (``tests/test_torch_moe_ep.py``'s ``FileStore`` harness),
with parameters and input laid out by the sharding rules; the reference
runs unsharded on the host.  Output and the gradients of ``sum(out *
cot) + aux`` with respect to the input and every parameter agree within
1e-5, float32.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import distribute_tensor

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.models import shardctx
from repro_torch.tree import tree_map
from test_torch_moe_ep import WORLD, _grads, torch_params

# (B, T, d, dff, E, top_k, router skew, shared expert): "b1" and "b3":
# batches 2 data ranks do not divide, tokens replicated, experts over
# "model" (2 each; "b3" skewed to expert 0, so some rank's groups are
# empty); "e6": 6 experts, which 4 model ranks do not divide
# (replicated), tokens over "data"
CASES = {
    "b1": (1, 3, 16, 32, 8, 2, 0.0, True),
    "b3": (3, 4, 16, 24, 8, 2, 3.0, False),
    "e6": (4, 2, 16, 16, 6, 2, 0.0, True),
}


def make_inputs(case, seed=0):
    B, T, d, dff, E, k, skew, shared = CASES[case]
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
    return inp, k


def _worker(rank, store_path, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        torch.set_num_threads(1)
        mesh = make_host_mesh(data=2, model=4, device_type="cpu")
        for case in CASES:
            inp, k = make_inputs(case)
            x, cot = torch.from_numpy(inp["x"]), torch.from_numpy(inp["cot"])
            p = torch_params(inp)
            shard = SH.params_shardings(mesh, None, {"moe": p})["moe"]
            pd = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), p,
                          shard)
            b_pl = SH.batch_shardings(mesh, {"x": x})["x"]
            with shardctx.hints(moe_mesh=(mesh, batch_axes(mesh))):
                out, aux, g = _grads(pd, distribute_tensor(x, mesh, b_pl),
                                     distribute_tensor(cot, mesh, b_pl), k,
                                     2.0)
            if rank == 0:
                np.savez(f"{out_dir}/{case}.npz", out=out.numpy(),
                         aux=aux.numpy(),
                         **{n: t.numpy() for n, t in g.items()})
    finally:
        dist.destroy_process_group()


def reference(inp, k):
    """The reference's unsharded moe_ffn: out, aux and the gradients of
    sum(out * cot) + aux, named as ``_grads`` names them."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    x, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
    p = {n: jnp.asarray(v) for n, v in inp.items()
         if n not in ("x", "cot") and not n.startswith("s_")}
    if "s_w_gate" in inp:
        p["shared"] = {n[2:]: jnp.asarray(v) for n, v in inp.items()
                       if n.startswith("s_")}

    def loss(p, x):
        out, aux = JL.moe_ffn(p, x, top_k=k)
        return (out * cot).sum() + aux

    out, aux = JL.moe_ffn(p, x, top_k=k)
    gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
    grads = {"g_x": gx, **{"g_" + n: v for n, v in gp.items()
                           if n != "shared"},
             **{"g_s_" + n: v for n, v in gp.get("shared", {}).items()}}
    return np.asarray(out), np.asarray(aux), {n: np.asarray(v)
                                              for n, v in grads.items()}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_sharded")
    mp.spawn(_worker, args=(str(tmp / "store"), str(tmp)), nprocs=WORLD,
             join=True)
    return {case: np.load(tmp / f"{case}.npz") for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_moe_ffn_matches_reference_on_2x4(port_runs, case):
    inp, k = make_inputs(case)
    out, aux, grads = reference(inp, k)
    port = port_runs[case]
    np.testing.assert_allclose(port["out"], out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port["aux"], aux, atol=1e-6, rtol=0)
    assert set(grads) == {n for n in port.files if n.startswith("g_")}
    for n, want in grads.items():
        np.testing.assert_allclose(port[n], want, atol=1e-5, rtol=1e-5,
                                   err_msg=n)
