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
from test_torch_kernels import _SMOKE       # chip_smoke.py, phase 2's cases

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


# ---------------------------------------------------------------------------
# The bf16 kernels' work list (``tile_walk``, the plain specification of
# csrc/grouped_mm.cu's persistent walk), over CASES at several split
# counts and over chip_smoke.py phase 2's draws at their own shapes and
# the split count and grid the wrapper gives them on a 132-SM card.
# ---------------------------------------------------------------------------

SMS = 132                                   # an H100's SMs


def _walk_case(kind, i):
    """(ends, M, K, N, wgrad, splits) of CASES[i] at split count 1 + i % 3
    ("cases"), or of phase 2's case i ("phase2")."""
    if kind == "cases":
        sizes, tail, K, N = CASES[i]
        return (np.cumsum(sizes), sum(sizes) + tail, K, N, False,
                1 + i % 3)
    label, _, _, _, K, N, op = _SMOKE.GMM_CASES[i][:7]
    E, sizes, M = _SMOKE.gmm_draw(i)
    if op == "dx":      # y = dy w[e]^T: contraction over N, output K wide
        K, N = N, K
    wgrad = op == "wgrad"
    splits = 1 if wgrad else GM.fwd_splits(M, K, N, E, SMS)
    return np.cumsum(sizes), M, K, N, wgrad, splits


WALKS = ([("cases", i) for i in range(len(CASES))]
         + [("phase2", i) for i in range(len(_SMOKE.GMM_CASES))])
WALK_IDS = [f"{k}-{i}" for k, i in WALKS]


@pytest.mark.parametrize("kind,i", WALKS, ids=WALK_IDS)
def test_tile_walk_covers_every_output_once(kind, i):
    ends, M, K, N, wgrad, splits = _walk_case(kind, i)
    rows = GM.group_rows(ends, M)
    E, used = len(ends), rows[-1][0]
    items = GM.tile_walk(ends, M, K, N, wgrad=wgrad, splits=splits)
    if wgrad:
        # every expert: its tiles partition (K, N), each summing exactly
        # the group's rows (an empty group: zero tiles, no rows)
        seen = np.zeros((E, GM._cdiv(K, GM.WG_TILE), GM._cdiv(N, GM.WG_TILE)),
                        np.int32)
        for it in items:
            assert (it.r0, it.r1) == rows[it.expert]
            assert it.k1 - it.k0 == min(GM.WG_TILE, K - it.k0) > 0
            assert it.n1 - it.n0 == min(GM.WG_TILE, N - it.n0) > 0
            seen[it.expert, it.k0 // GM.WG_TILE, it.n0 // GM.WG_TILE] += 1
        assert (seen == 1).all()
        assert [it.expert for it in items] == sorted(it.expert for it in items)
        return
    cover = np.zeros((splits, M, N), np.int16)
    kspan = {}
    for it in items:
        lo, hi = rows[it.expert]
        # a row tile stays inside its group (the tail: inside [used, M))
        assert lo <= it.r0 < it.r1 <= hi and it.r1 - it.r0 <= GM.FWD_ROWS
        assert it.box == min(b for b in GM.ROW_BOXES if b >= it.r1 - it.r0)
        assert it.n1 - it.n0 == min(GM.FWD_COLS, N - it.n0) > 0
        if it.expert == E:                   # zero tiles past ends[-1]
            assert splits == 1 and it.k0 == it.k1 == 0
        else:
            kspan.setdefault((it.r0, it.n0), []).append(
                (it.split, it.k0, it.k1))
        cover[it.split, it.r0:it.r1, it.n0:it.n1] += 1
    # each output element below ends[-1] once per split; the tail once
    # (splits == 1: the walk's zero tiles) or never (the sum pass zeros it)
    assert (cover[:, :used] == 1).all()
    assert (cover[:, used:] == (1 if splits == 1 else 0)).all()
    # the splits of each tile partition K, in split order
    for spans in kspan.values():
        spans.sort()
        assert [s for s, _, _ in spans] == list(range(splits))
        assert spans[0][1] == 0 and spans[-1][2] == K
        assert all(a[2] == b[1] for a, b in zip(spans, spans[1:]))
    # expert-major order, the tail last
    order = [it.expert for it in items]
    assert order == sorted(order)
    # an empty group has no tile
    assert {it.expert for it in items} >= {
        e for e in range(E) if rows[e][1] > rows[e][0]}
    assert all(rows[it.expert][1] > rows[it.expert][0] for it in items)


def test_fwd_splits_and_grid_from_shapes():
    """The split count gives a split at least MIN_SPLIT_STAGES stages and
    enough units where the shapes allow few tiles (llama4's decode)."""
    assert GM.fwd_splits(4, 8192, 5120, 128, SMS) == 8
    assert GM.fwd_splits(4, 5120, 8192, 128, SMS) == 5
    assert GM.fwd_splits(32, 4096, 1536, 128, SMS) == 4
    for M, K, N in ((2048, 4096, 1536), (2048, 1536, 4096), (8192, 4096, 1536),
                    (256, 5120, 8192), (32, 1536, 4096)):
        assert GM.fwd_splits(M, K, N, 128, SMS) == 1
    for M, K, N, E in ((1, 8, 8, 1), (4, 8192, 5120, 128), (33, 1024, 64, 3)):
        s = GM.fwd_splits(M, K, N, E, SMS)
        assert 1 <= s <= max(1, GM._cdiv(K, GM.FWD_K) // GM.MIN_SPLIT_STAGES)
        assert 1 <= GM.fwd_ctas(M, N, E, s, SMS) <= SMS
    assert GM.wgrad_ctas(16, 8, 1, SMS) == 1
    assert GM.wgrad_ctas(4096, 1536, 128, SMS) == SMS


def _emulate(ends, x, w, dy, wgrad, splits):
    """The bf16 kernels' arithmetic over the walk in numpy: f32 sums tile
    by tile, stage by stage (FWD_K of K; WG_ROWS of the group's rows),
    split partials summed in split order, one rounding to bf16."""
    M, K = x.shape
    xf, wf = x.float().numpy(), w.float().numpy()
    if wgrad:
        dyf = dy.float().numpy()
        E, N = len(ends), dy.shape[1]
        out = np.zeros((E, K, N), np.float32)
        for it in GM.tile_walk(ends, M, K, N, wgrad=True):
            acc = np.zeros((it.k1 - it.k0, it.n1 - it.n0), np.float32)
            for r in range(it.r0, it.r1, GM.WG_ROWS):
                r1 = min(r + GM.WG_ROWS, it.r1)
                acc += xf[r:r1, it.k0:it.k1].T @ dyf[r:r1, it.n0:it.n1]
            out[it.expert, it.k0:it.k1, it.n0:it.n1] = acc
        return torch.from_numpy(out).bfloat16()
    N = w.shape[2]
    part = np.zeros((splits, M, N), np.float32)
    for it in GM.tile_walk(ends, M, K, N, splits=splits):
        acc = np.zeros((it.r1 - it.r0, it.n1 - it.n0), np.float32)
        for k in range(it.k0, it.k1, GM.FWD_K):
            k1 = min(k + GM.FWD_K, it.k1)
            acc += (xf[it.r0:it.r1, k:k1]
                    @ wf[min(it.expert, len(ends) - 1), k:k1, it.n0:it.n1])
        part[it.split, it.r0:it.r1, it.n0:it.n1] = acc
    y = part[0]
    for s in range(1, splits):
        y = y + part[s]
    y[GM.group_rows(ends, M)[-1][0]:] = 0      # the sum pass's tail
    return torch.from_numpy(y).bfloat16()


@pytest.mark.parametrize("kind,i", WALKS, ids=WALK_IDS)
def test_tile_walk_emulation_matches_plain(kind, i):
    """Over phase 2's draws the rows, groups and split count are the
    case's own, K and N cut to 384 and 256 (the walk's columns and K
    blocks repeat; its rows and groups are what the draws exercise)."""
    ends, M, K, N, wgrad, splits = _walk_case(kind, i)
    if kind == "phase2":
        K, N = 384, 256
    E = len(ends)
    rng = np.random.default_rng(100 + i)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((E, K, N)) / np.sqrt(K))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32))
    x, w, dy = x.bfloat16(), w.bfloat16(), dy.bfloat16()
    te = torch.from_numpy(np.asarray(ends, np.int32))
    got = _emulate(ends, x, w, dy, wgrad, splits)
    want = (GM.grouped_mm_wgrad_ref(x, dy, te) if wgrad
            else GM.grouped_mm_ref(x, w, te))
    # group by group, each on its own scale, so a small group's fault shows
    tol = TOL["bfloat16"]
    b = [0] + [int(v) for v in ends]
    for e in range(E):
        g, r = ((got[e], want[e]) if wgrad else
                (got[b[e]:b[e + 1]], want[b[e]:b[e + 1]]))
        if r.numel():
            err = float((g.float() - r.float()).abs().max())
            assert err <= tol + tol * float(r.float().abs().max()), e
    if not wgrad:
        assert bool((got[int(ends[-1]):] == 0).all())


def test_cuda_walk_is_tile_walk():
    """csrc/grouped_mm.cu compiled for the CPU (tools/cuda_emu: every CUDA
    thread a host thread, TMA / mbarrier / wgmma emulated): its bf16
    kernels take exactly tile_walk()'s units, unit u on CTA u % ctas,
    with 1 and 3 K splits, and their outputs, and the f32 kernels', match
    the plain versions group by group, a second call bit-identical."""
    import importlib.util
    import shutil
    from pathlib import Path
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    path = (Path(__file__).resolve().parents[1] / "tools" / "cuda_emu"
            / "emulate.py")
    spec = importlib.util.spec_from_file_location("_cuda_emu", path)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    assert emu.check_grouped_mm()
