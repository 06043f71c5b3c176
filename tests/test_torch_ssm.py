"""Port of the Mamba2 (SSD) family against the reference.

The same numpy-seeded inputs and weights (the reference's own parameter
tree, through ``repro_torch.bridge``) go through the reference and the
port on the CPU.  The reference's ``ssd_scan`` is its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it; the port's wrapper
takes its plain version for CPU tensors.  The CUDA kernel itself is held
against that plain version on the card by ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.kernels.ssd_scan.ops import ssd as ref_ssd
from repro.kernels.ssd_scan.ref import ssd_sequential_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as ref_ssd_scan
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import steps as JS
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import steps as TS

# the reference kernel tests' tolerances (tests/test_kernels.py:20)
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Model-level f32 tolerance: the two packages run the same algorithm but
# sum in other orders (XLA vs PyTorch CPU kernels), through 2 layers and
# a 1024-way unembedding.
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(x, dtype="float32"):
    """One numpy array as (jax array, torch tensor) with identical values
    in ``dtype``."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x.copy()).to(
        TORCH[dtype])


def _ssd_inputs(rng, B, L, H, P, N, use_h0, dtype):
    """The reference kernel test's input distribution, drawn with numpy:
    ((jax x, dt, A, Bm, Cm, h0), (torch ...))."""
    def n(*s):
        return rng.standard_normal(s).astype(np.float32)

    x, Bm, Cm = n(B, L, H, P) * 0.5, n(B, L, N) * 0.5, n(B, L, N) * 0.5
    dt = np.logaddexp(n(B, L, H), 0).astype(np.float32)   # softplus
    A = -np.exp(n(H) * 0.3)
    h0 = n(B, H, P, N) * 0.2 if use_h0 else None
    pairs = [_both(a, d) if a is not None else (None, None)
             for a, d in ((x, dtype), (dt, "float32"), (A, "float32"),
                          (Bm, dtype), (Cm, dtype), (h0, "float32"))]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    ref, got = ref_get_config("mamba2-2.7b"), get_config("mamba2-2.7b")
    if reduced:
        ref, got = ref.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.n_layers, got.d_model, got.d_inner, got.ssm_heads,
            got.ssm_head_dim, got.ssm_state, got.ssm_chunk, got.vocab) == (
        ref.n_layers, ref.d_model, ref.d_inner, ref.ssm_heads,
        ref.ssm_head_dim, ref.ssm_state, ref.ssm_chunk, ref.vocab)


# ---------------------------------------------------------------------------
# ssd_scan: the plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,L,H,P,N,chunk,use_h0", [
    (2, 64, 4, 16, 8, 16, False),
    (1, 50, 2, 32, 16, 16, True),     # non-divisible L (padding)
    (2, 128, 8, 8, 4, 32, False),
    (1, 33, 3, 8, 8, 8, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas(B, L, H, P, N, chunk, use_h0, dtype):
    rng = np.random.default_rng(4)
    j, t = _ssd_inputs(rng, B, L, H, P, N, use_h0, dtype)
    y1, h1 = ref_ssd_scan(*j[:5], chunk=chunk, h0=j[5])
    y2, h2 = SS.ssd_scan(*t[:5], chunk=chunk, h0=t[5])
    assert y2.dtype == TORCH[dtype] and h2.dtype == torch.float32
    assert y2.shape == (B, L, H, P) and h2.shape == (B, H, P, N)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(y2), _np(y1), **tol)
    np.testing.assert_allclose(_np(h2), _np(h1), atol=tol["atol"] * 10,
                               rtol=tol["rtol"] * 10)
    if dtype == "float32":       # sequential ground truth (bf16 accumulates)
        y3, h3 = ssd_sequential_ref(*j[:5], h0=j[5])
        np.testing.assert_allclose(_np(y2), _np(y3), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(h2), _np(h3), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,L,H,P,N,chunk,use_h0", [
    (2, 64, 3, 8, 8, 16, True),       # four chunks through the carry
    (1, 50, 2, 16, 8, 16, False),     # L not a multiple of the chunk
    (2, 70, 2, 8, 16, 32, True),
    (1, 33, 3, 8, 4, 8, False),
    (1, 96, 2, 16, 16, 32, True),
    (2, 40, 1, 8, 8, 64, True),       # one chunk, shorter than chunk
])
def test_ssd_scan_passes_compose(B, L, H, P, N, chunk, use_h0):
    """The CUDA kernel's passes in plain PyTorch (kernels/ssd_scan.py: the
    dAc scan and C Bᵀ, the chunk states, the carry over chunks, the chunk
    outputs) compose to ssd_scan_ref and to the reference's Pallas
    ssd_scan in interpret mode within f32 2e-5; each pass matches its
    definition (the scan against a cumsum, the carry's first state is h0
    or 0 and its last is h_final)."""
    rng = np.random.default_rng(20 + L)
    j, t = _ssd_inputs(rng, B, L, H, P, N, use_h0, "float32")
    x, dt, A, Bm, Cm, h0 = t
    y, h = SS.ssd_scan_passes(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    y_ref, h_ref = SS.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    y_pl, h_pl = ref_ssd_scan(*j[:5], chunk=chunk, h0=j[5])
    tol = TOL["float32"]
    for got, want in ((y, y_ref), (h, h_ref), (y, y_pl), (h, h_pl)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)

    Q = min(chunk, L)
    nc = -(-L // Q)
    dac = SS.ssd_chunk_cumsum(dt, A, chunk=chunk)
    assert dac.shape == (B, nc, Q, H)
    dA = SS._chunked(dt * A, Q)
    np.testing.assert_allclose(_np(dac), _np(torch.cumsum(dA, dim=2)),
                               **tol)
    scores = SS.ssd_chunk_scores(Bm, Cm, chunk=chunk)
    assert scores.shape == (B, nc, Q, Q)
    states = SS.ssd_chunk_states(x, dt, Bm, dac, chunk=chunk)
    h_in, h_last = SS.ssd_state_carry(states, dac, h0)
    assert h_in.shape == (B, nc, H, P, N)
    first = torch.zeros_like(h_in[:, 0]) if h0 is None else h0
    assert torch.equal(h_in[:, 0], first) and torch.equal(h_last, h)


def test_ssd_op_adds_skip_term():
    rng = np.random.default_rng(5)
    j, t = _ssd_inputs(rng, 2, 40, 3, 8, 8, True, "float32")
    D = rng.standard_normal(3).astype(np.float32)
    jd, td = _both(D)
    y1, h1 = ref_ssd(*j[:5], jd, chunk=16, h0=j[5])
    y2, h2 = SS.ssd(*t[:5], td, chunk=16, h0=t[5])
    np.testing.assert_allclose(_np(y2), _np(y1), **TOL["float32"])
    np.testing.assert_allclose(_np(h2), _np(h1), atol=2e-4, rtol=2e-4)


def test_ssd_scan_refuses_other_devices():
    """Only CPU tensors take the plain version; a device with no kernel
    raises instead of falling back."""
    x = torch.empty((1, 4, 2, 8), device="meta")
    dt = torch.empty((1, 4, 2), device="meta")
    A = torch.empty((2,), device="meta")
    Bm = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        SS.ssd_scan(x, dt, A, Bm, Bm, chunk=4)


# ---------------------------------------------------------------------------
# Layer functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_and_conv_step_match(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 11, 24))
    w = rng.standard_normal((4, 24)) * 0.5
    b = rng.standard_normal(24) * 0.1
    st = rng.standard_normal((2, 3, 24))
    (jx, tx), (jw, tw), (jb, tb), (js, ts) = (
        _both(a, dtype) for a in (x, w, b, st))
    np.testing.assert_allclose(_np(TL.causal_conv1d(tx, tw, tb)),
                               _np(JL.causal_conv1d(jx, jw, jb)),
                               **TOL[dtype])
    for T in (1, 5):
        jy, jst = JL.conv_step(js, jx[:, :T], jw, jb)
        ty, tst = TL.conv_step(ts, tx[:, :T], tw, tb)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL[dtype])
        np.testing.assert_array_equal(_np(tst), _np(jst))


def test_gated_rms_norm_and_softplus_match():
    rng = np.random.default_rng(7)
    (jy, ty), (jz, tz), (jw, tw) = (
        _both(rng.standard_normal(s)) for s in ((2, 5, 32), (2, 5, 32), 32))
    np.testing.assert_allclose(_np(TL.gated_rms_norm(ty, tz, tw)),
                               _np(JL.gated_rms_norm(jy, jz, jw)),
                               **TOL["float32"])
    # no linear cut-off above 20, unlike torch's default F.softplus
    v = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 40.0], np.float32)
    jv, tv = _both(v)
    np.testing.assert_allclose(_np(TL.softplus(tv)), _np(jax.nn.softplus(jv)),
                               rtol=1e-6)


def test_ssd_chunked_and_decode_match():
    rng = np.random.default_rng(8)
    j, t = _ssd_inputs(rng, 2, 48, 2, 8, 4, True, "float32")
    y1, h1 = JL.ssd_chunked(*j[:5], chunk=16, h0=j[5])
    y2, h2 = TL.ssd_chunked(*t[:5], chunk=16, h0=t[5])
    np.testing.assert_allclose(_np(y2), _np(y1), **TOL["float32"])
    np.testing.assert_allclose(_np(h2), _np(h1), atol=2e-4, rtol=2e-4)
    def first_token(x, dt, A, Bm, Cm):
        return x[:, :1], dt[:, :1], A, Bm[:, :1], Cm[:, :1]

    yd1, hd1 = JL.ssd_decode(*first_token(*j[:5]), j[5])
    yd2, hd2 = TL.ssd_decode(*first_token(*t[:5]), t[5])
    np.testing.assert_allclose(_np(yd2), _np(yd1), **TOL["float32"])
    np.testing.assert_allclose(_np(hd2), _np(hd1), **TOL["float32"])


# ---------------------------------------------------------------------------
# The reduced mamba2 through the bridge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    """The reduced mamba2-2.7b (2 layers, d_model 256, 16 heads of 32,
    state 16, chunk 32, f32) with the reference's own weights; D,
    dt_bias, conv_b and gate_norm get seeded noise so every term of the
    block is exercised."""
    jcfg = ref_get_config("mamba2-2.7b").reduced()
    tcfg = get_config("mamba2-2.7b").reduced()
    params = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    lay = params["layers"]
    for key, scale in (("D", 0.5), ("dt_bias", 0.5), ("conv_b", 0.1),
                       ("gate_norm", 0.2)):
        lay[key] = (lay[key] + rng.standard_normal(lay[key].shape)
                    * scale).astype(lay[key].dtype)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params,
                tp=bridge.params_from_reference(params, device="cpu"))


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["no cache", "cache T=1", "cache T=7"])
@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_mamba_block_matches(mamba, impl, mode):
    jcfg = mamba["jcfg"].replace(attn_impl=impl)
    tcfg = mamba["tcfg"].replace(attn_impl=impl)
    jp = _layer0(mamba["jp"]["layers"])
    tp = TM.layer_slice(mamba["tp"]["layers"], 0)
    rng = np.random.default_rng(10)
    T = {"no cache": 12, "cache T=1": 1, "cache T=7": 7}[mode]
    jx, tx = _both(rng.standard_normal((2, T, jcfg.d_model)))
    jc = tc = None
    if mode != "no cache":
        conv = rng.standard_normal((2, jcfg.ssm_conv_width - 1,
                                    jcfg.d_inner + 2 * jcfg.ssm_state))
        state = rng.standard_normal((2, jcfg.ssm_heads, jcfg.ssm_head_dim,
                                     jcfg.ssm_state)) * 0.3
        (jcv, tcv), (jst, tst) = _both(conv), _both(state)
        jc, tc = {"conv": jcv, "state": jst}, {"conv": tcv, "state": tst}
    jo, jnc, ji = JL.mamba_block(jp, jcfg, jx, jc, return_importance=True)
    to, tnc, ti = TL.mamba_block(tp, tcfg, tx, tc, return_importance=True)
    np.testing.assert_allclose(_np(to), _np(jo), **MODEL_TOL)
    np.testing.assert_allclose(_np(ti), _np(ji), **TOL["float32"])
    if mode != "no cache":
        assert tnc is tc                      # written in place
        for key in ("conv", "state"):     # conv: in_proj rows, matmul'd
            np.testing.assert_allclose(_np(tc[key]), _np(jnc[key]),
                                       **MODEL_TOL)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_forward_logits_match(mamba, impl):
    jcfg = mamba["jcfg"].replace(attn_impl=impl)
    tcfg = mamba["tcfg"].replace(attn_impl=impl)
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 40))
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    jl, _, ji, _ = JM.forward(jcfg, mamba["jp"], jnp.asarray(toks, jnp.int32),
                              jnp.asarray(pos), return_importance=True)
    tl, _, ti, _ = TM.forward(tcfg, mamba["tp"], torch.from_numpy(toks),
                              torch.from_numpy(pos.copy()),
                              return_importance=True)
    assert tl.shape == (2, 40, jcfg.vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    np.testing.assert_allclose(_np(ti), _np(ji), **MODEL_TOL)


def test_prefill_decode_matches_full_forward(mamba):
    """As tests/test_models.py:73: a cached prefill then single-token
    decode steps equal the reference's full forward at those positions."""
    jcfg, tcfg = mamba["jcfg"], mamba["tcfg"].replace(attn_impl="pallas")
    B, T, extra = 2, 16, 4
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, (B, T + extra))
    full = _np(JM.forward(jcfg, mamba["jp"], jnp.asarray(toks, jnp.int32),
                          JM.default_positions(B, T + extra))[0])
    cache = TM.init_cache(tcfg, B, T + extra, device="cpu")
    tt = torch.from_numpy(toks)
    lp, cache, _, _ = TM.forward(tcfg, mamba["tp"], tt[:, :T],
                                 TM.default_positions(B, T, device="cpu"),
                                 cache=cache)
    np.testing.assert_allclose(_np(lp), full[:, :T], **MODEL_TOL)
    for t in range(T, T + extra):
        ld, cache, _, _ = TM.forward(
            tcfg, mamba["tp"], tt[:, t:t + 1],
            torch.full((B, 1), t, dtype=torch.int32), cache=cache)
        np.testing.assert_allclose(_np(ld[:, 0]), full[:, t], **MODEL_TOL)


def test_verify_chunk_matches_full_forward(mamba):
    """As tests/test_models.py:97: a multi-token chunk over a cached prefix
    (the h0 and T > 1 conv_step path) equals the full forward, and the
    ported verify step gives the reference verify step's logits."""
    jcfg, tcfg = mamba["jcfg"], mamba["tcfg"].replace(attn_impl="pallas")
    B, T, C = 2, 12, 5
    toks = np.random.default_rng(13).integers(0, jcfg.vocab, (B, T + C))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    full = _np(JM.forward(jcfg, mamba["jp"], jt,
                          JM.default_positions(B, T + C))[0])
    jcache = JM.init_cache(jcfg, B, T + C)
    _, jcache = JS.make_prefill_step(jcfg)(mamba["jp"], jcache, jt[:, :T])
    tcache = TM.init_cache(tcfg, B, T + C, device="cpu")
    _, tcache = TS.make_prefill_step(tcfg)(mamba["tp"], tcache, tt[:, :T])
    pos = np.broadcast_to(np.arange(T, T + C, dtype=np.int32), (B, C))
    jl, _ = JS.make_verify_step(jcfg)(mamba["jp"], jcache, jt[:, T:],
                                      jnp.asarray(pos))
    tl, _ = TS.make_verify_step(tcfg)(mamba["tp"], tcache, tt[:, T:],
                                      torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    np.testing.assert_allclose(_np(tl), full[:, T:], atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_greedy_tokens_identical(mamba, impl):
    """Prefill then 8 greedy decode steps through the step factories:
    token streams identical to the reference's."""
    jcfg = mamba["jcfg"]
    tcfg = mamba["tcfg"].replace(attn_impl=impl)
    prompt = np.random.default_rng(14).integers(0, jcfg.vocab, (2, 37))
    jpre, jdec = JS.make_prefill_step(jcfg), JS.make_decode_step(jcfg)
    tpre, tdec = TS.make_prefill_step(tcfg), TS.make_decode_step(tcfg)
    jl, jc = jpre(mamba["jp"], JM.init_cache(jcfg, 2, 64),
                  jnp.asarray(prompt, jnp.int32))
    tl, tc = tpre(mamba["tp"], TM.init_cache(tcfg, 2, 64, device="cpu"),
                  torch.from_numpy(prompt))
    jtoks, ttoks = [], []
    for step in range(8):
        jn = np.asarray(jnp.argmax(jl, -1))
        tn = tl.argmax(-1)
        jtoks.append(jn.tolist())
        ttoks.append(tn.tolist())
        pos = 37 + step
        jl, jc = jdec(mamba["jp"], jc, jnp.asarray(jn[:, None], jnp.int32),
                      jnp.full((2, 1), pos, jnp.int32))
        tl, tc = tdec(mamba["tp"], tc, tn[:, None],
                      torch.full((2, 1), pos, dtype=torch.int32))
    assert ttoks == jtoks


# ---------------------------------------------------------------------------
# Layout, dtypes, bridge
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_match_reference_layout(dtype):
    jcfg = ref_get_config("mamba2-2.7b").reduced().replace(dtype=dtype)
    tcfg = get_config("mamba2-2.7b").reduced().replace(dtype=dtype)
    ref = dict(_leaves(jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                                      jax.random.PRNGKey(0))))
    got = dict(_leaves(TM.init_params(tcfg, seed=0, device="cpu")))
    ref_c = dict(_leaves(jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 16))))
    got_c = dict(_leaves(TM.init_cache(tcfg, 3, 16, device="cpu")))
    for r, g in ((ref, got), (ref_c, got_c)):
        assert r.keys() == g.keys()
        for key, leaf in r.items():
            assert tuple(g[key].shape) == leaf.shape, key
            assert str(g[key].dtype) == f"torch.{leaf.dtype}", key


def test_bridge_keeps_float32_leaves():
    """A bridged bf16 tree keeps the reference's leaf dtypes: A_log, D
    and dt_bias stay f32 (bit-identical), the rest is cast."""
    jcfg = ref_get_config("mamba2-2.7b").reduced()
    ref = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(1)))
    got = bridge.params_from_reference(ref, device="cpu",
                                       dtype=torch.bfloat16)
    for key in ("A_log", "D", "dt_bias"):
        assert got["layers"][key].dtype == torch.float32, key
        np.testing.assert_array_equal(got["layers"][key].numpy(),
                                      ref["layers"][key])
    for key in ("in_proj", "conv_w", "out_proj", "gate_norm"):
        assert got["layers"][key].dtype == torch.bfloat16, key
    assert got["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "forward"])
def test_unknown_family_raises(entry):
    """Every family of the reference is ported; an unknown one is refused
    with the reference's ``ValueError``."""
    cfg = get_config("mamba2-2.7b").reduced()
    params = TM.init_params(cfg, device="cpu")
    bad = cfg.replace(family="diffusion")
    calls = {
        "init_params": lambda: TM.init_params(bad, device="cpu"),
        "init_cache": lambda: TM.init_cache(bad, 1, 32, device="cpu"),
        "forward": lambda: TM.forward(
            bad, params, torch.zeros((1, 4), dtype=torch.long),
            TM.default_positions(1, 4, device="cpu")),
    }
    with pytest.raises(ValueError, match="diffusion"):
        calls[entry]()


def test_paged_cache_refuses_ssm():
    cfg = get_config("mamba2-2.7b").reduced()
    with pytest.raises(ValueError, match="paged"):
        TM.init_cache(cfg, 1, 32, cache_impl="paged", device="cpu")


def test_cloud_engine_refuses_ssm():
    from repro_torch.serving.engine import CloudEngine
    cfg = get_config("mamba2-2.7b").reduced()
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="ssm"):
        CloudEngine(cfg, params, max_slots=1, s_max=32, device="cpu")
