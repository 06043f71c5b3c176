"""Port of the hybrid family (zamba2: Mamba2 rounds, each closed by one
weight-shared MHA block) against the reference.

Two small configs: the reduced ``zamba2-2.7b`` (4 Mamba2 layers in 2
rounds, d_model 256, head dim 64) and a head-dim-80 variant (d_model 320,
4 heads of 80: the width of zamba2's shared block; ``ssm_heads=0`` lets
the config derive its SSM heads from the new width).  The same
numpy-seeded inputs and the reference's own weights (through
``repro_torch.bridge``) go through both packages on the CPU in float32.
Under ``attn_impl="pallas"`` the reference runs its Pallas kernels in
interpret mode and the port its kernel wrappers' plain versions; the
CUDA kernels are held against those on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import io as ckpt_io
from repro.configs import get_config as ref_get_config
from repro.models import model as JM
from repro.models import steps as JS
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import steps as TS

VARIANTS = {"reduced": {}, "hd80": dict(d_model=320, head_dim=80,
                                        ssm_heads=0)}
# f32 through 4 Mamba2 blocks, 2 attention blocks and a 1024-way
# unembedding, the two packages summing in other orders
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
B, T, EXTRA = 2, 24, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(variant, dtype="float32"):
    kw = dict(VARIANTS[variant], dtype=dtype)
    return (ref_get_config("zamba2-2.7b").reduced().replace(**kw),
            get_config("zamba2-2.7b").reduced().replace(**kw))


@pytest.fixture(scope="module")
def hybrids():
    """Per variant, built once: both configs, the reference's weights with
    seeded noise on D, dt_bias, conv_b and gate_norm (so every term of the
    Mamba2 blocks is exercised), their port view, the tokens and the
    reference's full forward (logits and importance) under each
    attention implementation."""
    built = {}

    def get(variant):
        if variant in built:
            return built[variant]
        jcfg, tcfg = _configs(variant)
        jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
        rng = np.random.default_rng(30)
        lay = jp["mamba_rounds"]
        for key, scale in (("D", 0.5), ("dt_bias", 0.5), ("conv_b", 0.1),
                           ("gate_norm", 0.2)):
            lay[key] = (lay[key] + rng.standard_normal(lay[key].shape)
                        * scale).astype(lay[key].dtype)
        toks = rng.integers(0, jcfg.vocab, (B, T + EXTRA))
        pos = np.broadcast_to(np.arange(T + EXTRA, dtype=np.int32),
                              (B, T + EXTRA))
        full = {}
        for impl in ("blocked", "pallas"):
            logits, _, imp, _ = JM.forward(
                jcfg.replace(attn_impl=impl), jp,
                jnp.asarray(toks, jnp.int32), jnp.asarray(pos),
                return_importance=True)
            full[impl] = (np.asarray(logits), np.asarray(imp))
        built[variant] = dict(
            jcfg=jcfg, tcfg=tcfg, jp=jp, toks=toks, pos=pos, full=full,
            tp=bridge.params_from_reference(jp, device="cpu"))
        return built[variant]

    return get


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------------------
# Layout and bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_and_cache_match_reference_layout(variant, dtype):
    """``mamba_rounds`` with two leading axes (round, layer), one shared
    MHA layer, and the cache's ``{"mamba", "attn"}`` with one KV stack per
    round: the reference's keys, shapes and dtypes (A_log, D and dt_bias
    f32 whatever the model dtype)."""
    jcfg, tcfg = _configs(variant, dtype)
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
    rounds = tcfg.n_layers // tcfg.attn_every
    assert got[("mamba_rounds", "A_log")].shape[:2] == (rounds,
                                                        tcfg.attn_every)
    assert got[("shared_attn", "attn", "wk")].shape == (
        tcfg.d_model, tcfg.n_heads * tcfg.head_dim)       # MHA: n_kv = nh
    assert got_c[("attn", "k")].shape[0] == rounds


@pytest.mark.parametrize("form", ["nested", "flat"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bridge_carries_the_hybrid_tree(hybrids, variant, form, tmp_path):
    """The nested tree and the flat ``||`` form that ``checkpoint/io.py``
    writes both bridge to the reference's tree; cast to bf16, the f32
    leaves at depth 2 (``mamba_rounds/A_log``, ``D``, ``dt_bias``) stay f32
    and bit-identical."""
    jp = hybrids(variant)["jp"]
    if form == "flat":
        path = tmp_path / "zamba2.npz"
        ckpt_io.save(str(path), jp)
        src = dict(np.load(path))
        assert any("||" in k for k in src)
    else:
        src = jp
    ref = dict(_leaves(jp))
    got = dict(_leaves(bridge.params_from_reference(src, device="cpu")))
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), r)
    cast = bridge.params_from_reference(src, device="cpu",
                                        dtype=torch.bfloat16)
    for key in ("A_log", "D", "dt_bias"):
        leaf = cast["mamba_rounds"][key]
        assert leaf.dtype == torch.float32, key
        np.testing.assert_array_equal(leaf.numpy(), jp["mamba_rounds"][key])
    assert cast["mamba_rounds"]["in_proj"].dtype == torch.bfloat16
    assert cast["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Forward, cache, steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_and_importance_match(hybrids, variant, impl):
    """Logits, and the (B, T) importance: per round, the mean of the
    Mamba2 blocks' per-token |dt x| and the attention block's column
    sums, halved; then the mean over rounds."""
    h = hybrids(variant)
    tcfg = h["tcfg"].replace(attn_impl=impl)
    tl, _, ti, _ = TM.forward(tcfg, h["tp"], torch.from_numpy(h["toks"]),
                              torch.from_numpy(h["pos"].copy()),
                              return_importance=True)
    jl, ji = h["full"][impl]
    assert tl.shape == (B, T + EXTRA, tcfg.vocab)
    assert ti.shape == (B, T + EXTRA)
    np.testing.assert_allclose(tl.numpy(), jl, **MODEL_TOL)
    np.testing.assert_allclose(ti.numpy(), ji, **MODEL_TOL)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_decode_matches_full_forward(hybrids, variant, impl):
    """A cached prefill, then one-token decode steps (the shared block
    over each round's own KV cache, the Mamba2 states stepped), equal the
    reference's full forward at those positions."""
    h = hybrids(variant)
    tcfg = h["tcfg"].replace(attn_impl=impl)
    full = h["full"]["blocked"][0]
    tt = torch.from_numpy(h["toks"])
    cache = TM.init_cache(tcfg, B, T + EXTRA, device="cpu")
    lp, cache, _, _ = TM.forward(tcfg, h["tp"], tt[:, :T],
                                 TM.default_positions(B, T, device="cpu"),
                                 cache=cache)
    np.testing.assert_allclose(lp.numpy(), full[:, :T], **MODEL_TOL)
    assert (cache["attn"]["pos"][:, :, :T] >= 0).all()
    for t in range(T, T + EXTRA):
        ld, cache, _, _ = TM.forward(
            tcfg, h["tp"], tt[:, t:t + 1],
            torch.full((B, 1), t, dtype=torch.int32), cache=cache)
        np.testing.assert_allclose(ld[:, 0].numpy(), full[:, t], **MODEL_TOL)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_verify_chunk_matches_full_forward(hybrids, variant, impl):
    """A multi-token chunk over a cached prefix through the verify step
    (the h0 path of the scan, T > 1 conv steps, the shared block over the
    cached keys) equals the reference's verify step and full forward."""
    h = hybrids(variant)
    jcfg = h["jcfg"].replace(attn_impl=impl)
    tcfg = h["tcfg"].replace(attn_impl=impl)
    jt, tt = jnp.asarray(h["toks"], jnp.int32), torch.from_numpy(h["toks"])
    pos = h["pos"][:, T:].copy()
    jcache = JM.init_cache(jcfg, B, T + EXTRA)
    _, jcache = JS.make_prefill_step(jcfg)(h["jp"], jcache, jt[:, :T])
    jl, _ = JS.make_verify_step(jcfg)(h["jp"], jcache, jt[:, T:],
                                      jnp.asarray(pos))
    tcache = TM.init_cache(tcfg, B, T + EXTRA, device="cpu")
    _, tcache = TS.make_prefill_step(tcfg)(h["tp"], tcache, tt[:, :T])
    tl, _ = TS.make_verify_step(tcfg)(h["tp"], tcache, tt[:, T:],
                                      torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(tl.numpy(), h["full"]["blocked"][0][:, T:],
                               atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_tokens_identical(hybrids, variant, impl):
    """Prefill then 6 greedy decode steps through the step factories:
    token streams identical to the reference's model-level steps."""
    h = hybrids(variant)
    jcfg, tcfg = h["jcfg"], h["tcfg"].replace(attn_impl=impl)
    prompt = np.random.default_rng(31).integers(0, jcfg.vocab, (B, 19))
    jpre, jdec = JS.make_prefill_step(jcfg), JS.make_decode_step(jcfg)
    tpre, tdec = TS.make_prefill_step(tcfg), TS.make_decode_step(tcfg)
    jl, jc = jpre(h["jp"], JM.init_cache(jcfg, B, 32),
                  jnp.asarray(prompt, jnp.int32))
    tl, tc = tpre(h["tp"], TM.init_cache(tcfg, B, 32, device="cpu"),
                  torch.from_numpy(prompt))
    jtoks, ttoks = [], []
    for step in range(6):
        jn = np.asarray(jnp.argmax(jl, -1))
        tn = tl.argmax(-1)
        jtoks.append(jn.tolist())
        ttoks.append(tn.tolist())
        p = 19 + step
        jl, jc = jdec(h["jp"], jc, jnp.asarray(jn[:, None], jnp.int32),
                      jnp.full((B, 1), p, jnp.int32))
        tl, tc = tdec(h["tp"], tc, tn[:, None],
                      torch.full((B, 1), p, dtype=torch.int32))
    assert ttoks == jtoks


# ---------------------------------------------------------------------------
# What refuses the hybrid
# ---------------------------------------------------------------------------

def test_paged_cache_refuses_hybrid():
    _, cfg = _configs("reduced")
    with pytest.raises(ValueError, match="paged"):
        TM.init_cache(cfg, 1, 32, cache_impl="paged", device="cpu")


def test_cloud_engine_refuses_hybrid():
    """Bucket padding would enter the Mamba2 conv windows and states
    (ROADMAP queue 3, R6): the engine refuses, naming R6."""
    from repro_torch.serving.engine import CloudEngine
    _, cfg = _configs("reduced")
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"hybrid.*R6"):
        CloudEngine(cfg, params, max_slots=1, s_max=32, device="cpu")
