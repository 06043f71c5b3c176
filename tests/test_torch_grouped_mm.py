"""The grouped product (``kernels/grouped_mm.py``, the port's counterpart
of ``lax.ragged_dot``) and ``moe_ffn`` built on it, on the CPU.

The plain version is held against ``lax.ragged_dot`` with group sizes
that include empty groups and unused tail rows, in float32 (2e-5) and
bfloat16 (5e-2), and its input and weight gradients (the custom op's
autograd: the transposed product and ``grouped_mm_wgrad``) against
``jax.grad`` of the same.  ``moe_ffn`` traces on ``meta``, and a reduced
qwen3-moe decode at B 1 -- a batch the data axes do not divide -- traces
on a fake 2 x 4 world with every dot resolved and the grouped products'
FLOPs per device as their formula gives.  Inputs come from numpy seeds.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import grouped_mm as GM
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L

TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# (group sizes, unused tail rows, K, N): empty groups first, between and
# last; one group holding most rows; every row used
CASES = [((3, 0, 7, 5, 0), 4, 16, 24), ((0, 0, 12), 3, 8, 40),
         ((2, 9, 1, 4), 0, 32, 16), ((0, 1), 6, 24, 8)]


def _inputs(sizes, tail, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    M = sum(sizes) + tail
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), K, N)) / np.sqrt(K)).astype(
        np.float32)
    cot = rng.standard_normal((M, N)).astype(np.float32)
    ends = np.cumsum(sizes).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    return ((jnp.asarray(x, jdt), jnp.asarray(w, jdt),
             jnp.asarray(np.asarray(sizes, np.int32)), jnp.asarray(cot, jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
             torch.from_numpy(ends), torch.from_numpy(cot).to(tdt)))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_grouped_mm_matches_ragged_dot(case, dtype):
    sizes, tail, K, N = CASES[case]
    (jx, jw, jgs, _), (x, w, ends, _) = _inputs(sizes, tail, K, N, dtype,
                                                case)
    want = lax.ragged_dot(jx, jw, jgs)
    got = GM.grouped_mm(x, w, ends)
    assert got.dtype == x.dtype and got.shape == (x.shape[0], N)
    _close(got, want, dtype)
    assert bool((got[sum(sizes):] == 0).all())      # the unused tail rows
    # the plain version, with w read transposed as the input gradient does
    got_t = GM.grouped_mm_ref(x, w.transpose(1, 2).contiguous(), ends,
                              trans_w=True)
    _close(got_t, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_grouped_mm_grads_match_jax(case, dtype):
    sizes, tail, K, N = CASES[case]
    (jx, jw, jgs, jcot), (x, w, ends, cot) = _inputs(sizes, tail, K, N,
                                                     dtype, 10 + case)

    def loss(x, w):
        y = lax.ragged_dot(x, w, jgs)
        return (y.astype(jnp.float32) * jcot.astype(jnp.float32)).sum()

    want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(jx, jw)
    x.requires_grad_()
    w.requires_grad_()
    y = GM.grouped_mm(x, w, ends)
    dx, dw = torch.autograd.grad((y.float() * cot.float()).sum(), [x, w])
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _close(dx, want_dx, dtype)
    _close(dw, want_dw, dtype)
    # an expert with no row gets an exact zero gradient
    for e, n in enumerate(sizes):
        if n == 0:
            assert bool((dw[e] == 0).all())
    # the weight gradient's own entry point
    assert torch.equal(GM.grouped_mm_wgrad(x.detach(), y.detach(), ends),
                       GM.grouped_mm_wgrad_ref(x.detach(), y.detach(), ends))


@pytest.mark.parametrize("op", ["grouped_mm", "grouped_mm_wgrad"])
def test_custom_op_registrations(op):
    """Schema, autograd registration and the fake (meta) kernel agree
    with the CPU implementation."""
    _, (x, w, ends, cot) = _inputs((3, 0, 7, 5, 0), 4, 16, 24, "float32", 3)
    if op == "grouped_mm":
        args = (x.requires_grad_(), w.requires_grad_(), ends, False)
    else:
        args = (x, cot, ends)
    torch.library.opcheck(getattr(torch.ops.repro_torch, op).default, args,
                          test_utils=("test_schema",
                                      "test_autograd_registration",
                                      "test_faketensor"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_on_meta(dtype):
    x = torch.empty(10, 16, dtype=dtype, device="meta", requires_grad=True)
    w = torch.empty(4, 16, 24, dtype=dtype, device="meta",
                    requires_grad=True)
    ends = torch.empty(4, dtype=torch.int32, device="meta")
    y = GM.grouped_mm(x, w, ends)
    assert y.shape == (10, 24) and y.dtype == dtype and y.is_meta
    dx, dw = torch.autograd.grad(y.sum(), [x, w])
    assert dx.shape == x.shape and dw.shape == w.shape and dw.is_meta


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_ffn_on_meta(arch):
    cfg = get_config(arch).reduced()
    specs = SP.params_specs(cfg)
    moe = (specs["layers"] if "layers" in specs else specs["moe_layers"])["moe"]
    p = {k: v[0] for k, v in moe.items() if k != "shared"}
    x = torch.empty(3, 5, cfg.d_model, dtype=torch.bfloat16, device="meta")
    out, aux = L.moe_ffn(p, x, top_k=cfg.top_k)
    assert out.shape == x.shape and out.dtype == x.dtype and out.is_meta
    assert aux.shape == () and aux.dtype == torch.float32 and aux.is_meta


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_reduced_moe_decode_b1_dry_run_on_2x4(arch):
    """B 1 does not divide the data axis: moe_ffn_ep hands the layer to
    moe_ffn, which traces over DTensors as a local_map region.  Each of
    the 4 model ranks takes all B T k assignments through its experts'
    three grouped products (K = d gathered over "data", N = d_ff)."""
    cfg = get_config(arch).reduced()
    shape = InputShape("decode_b1", 256, 1, "decode")
    with D.fake_world(8):
        mesh = make_host_mesh(data=2, model=4)
        rec = D.trace_record(cfg, shape, mesh)
    assert rec["ok"] and rec["unresolved_dots"] == 0
    n_moe = cfg.n_layers // cfg.moe_every
    rows = 1 * 1 * cfg.top_k
    want = n_moe * 3 * 2 * rows * cfg.d_model * cfg.d_ff
    assert rec["flops_by_op"]["grouped_mm"] == want
    assert rec["flops_per_dev"] == sum(rec["flops_by_op"].values())
    assert "all-reduce" in rec["collective_by_kind"]
