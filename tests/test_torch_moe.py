"""Port of the MoE family against the reference, on the CPU.

``qwen3-moe-235b-a22b`` (every layer MoE, top-8) and
``llama4-maverick-400b-a17b`` (dense and MoE layers interleaved, top-1,
one shared expert) are copies of the reference's config files.  The
reference's own weights go through ``repro_torch.bridge``; inputs are
drawn from numpy seeds; everything runs in float32.  ``moe_ffn`` is held
against the reference's, expert choices included; the reduced configs'
forward, cached prefill + decode and verify step under
``attn_impl="blocked"`` and ``"pallas"`` (the reference's Pallas kernels
in interpret mode, the port's wrappers on their plain versions); and the
tiny pair with its LLM made MoE is served by both packages' engines,
on a dense cache and on a paged, prefix-sharing one: the greedy streams
of ``run_synera`` and ``run_cloud_centric`` must be identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs.synera_pair import tiny_pair
from repro.core.offload import OffloadPolicy as RefPolicy
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import steps as JS
from repro.serving import synergy as RSY
from repro.serving.device import DeviceRuntime as RefDevice
from repro.serving.engine import CloudEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.core.offload import OffloadPolicy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import steps as TS
from repro_torch.serving import synergy as SY
from repro_torch.serving.device import DeviceRuntime
from repro_torch.serving.engine import CloudEngine
from test_torch_paged import POOL_FIELDS

MOE = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
# total and active parameters of the full configs, in B (the reference's
# param_count and active_param_count)
PARAMS_B = {"qwen3-moe-235b-a22b": (235.09, 22.19),
            "llama4-maverick-400b-a17b": (397.69, 14.16)}
# f32 through 2 layers and a 1024-way unembedding, the two packages
# summing in other orders (XLA vs PyTorch CPU kernels)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
FFN_TOL = dict(atol=1e-5, rtol=1e-5)
B, T, EXTRA = 2, 20, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", MOE)
def test_config_matches_reference(name, reduced):
    ref, got = ref_get_config(name), get_config(name)
    if reduced:
        ref, got = ref.reduced(), got.reduced()
    assert got.family == "moe"
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    if not reduced:
        total, active = PARAMS_B[name]
        assert abs(got.param_count() / 1e9 - total) < 5e-3 * total
        assert abs(got.active_param_count() / 1e9 - active) < 5e-3 * active


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

# (label, E, top_k, n_shared, d, d_ff, B, T)
FFN_CASES = [
    ("E4 k2", 4, 2, 0, 64, 96, 2, 7),
    ("E4 k1 shared", 4, 1, 1, 64, 96, 2, 7),
    ("E16 k8 empty experts", 16, 8, 0, 64, 48, 1, 2),
    ("one row", 4, 2, 0, 64, 96, 1, 1),
]


@pytest.mark.parametrize("label,E,k,n_shared,d,dff,b,t", FFN_CASES,
                         ids=[c[0] for c in FFN_CASES])
def test_moe_ffn_matches_reference(label, E, k, n_shared, d, dff, b, t):
    jp = jax.tree.map(np.asarray, JL.init_moe(
        jax.random.PRNGKey(E + k + n_shared), d, dff, E, n_shared=n_shared))
    tp = bridge.params_from_reference(jp, device="cpu")
    x = np.random.default_rng(E * 10 + k).standard_normal(
        (b, t, d)).astype(np.float32)
    want, want_aux = JL.moe_ffn(jp, jnp.asarray(x), top_k=k)
    got, got_aux = TL.moe_ffn(tp, torch.from_numpy(x), top_k=k)
    assert got.shape == (b, t, d) and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    # the expert choices themselves, in lax.top_k's order
    xf = x.reshape(-1, d)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    _, want_e = jax.lax.top_k(probs, k)
    _, _, got_e = TL.moe_route(tp["router"], torch.from_numpy(xf), k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    if label == "E16 k8 empty experts":
        assert len(set(got_e.flatten().tolist())) < E


def test_moe_ffn_bf16_matches_reference():
    """bf16: the routing stays f32 (the router leaf is f32), the products
    and the weighted sum run in bf16, as the reference's."""
    jp = jax.tree.map(np.asarray, JL.init_moe(
        jax.random.PRNGKey(3), 64, 96, 4, n_shared=1, dtype=jnp.bfloat16))
    tp = bridge.params_from_reference(jp, device="cpu", dtype=torch.bfloat16)
    assert tp["router"].dtype == torch.float32
    x = np.random.default_rng(4).standard_normal((2, 5, 64)).astype(
        np.float32)
    want, want_aux = JL.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), top_k=2)
    got, got_aux = TL.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16),
                              top_k=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


# ---------------------------------------------------------------------------
# The reduced configs, model level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_models():
    """Per config, built once: reduced configs of both packages, the
    reference's weights and the port's view of them, the tokens, and the
    reference's full forward (logits, importance, aux) under each
    attention implementation."""
    built = {}

    def get(name):
        if name in built:
            return built[name]
        jcfg = ref_get_config(name).reduced()
        tcfg = get_config(name).reduced()
        jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
        rng = np.random.default_rng(21)
        toks = rng.integers(0, jcfg.vocab, (B, T + EXTRA))
        pos = np.broadcast_to(np.arange(T + EXTRA, dtype=np.int32),
                              (B, T + EXTRA))
        full = {}
        for impl in ("blocked", "pallas"):
            lg, _, imp, aux = JM.forward(
                jcfg.replace(attn_impl=impl), jp, jnp.asarray(toks, jnp.int32),
                jnp.asarray(pos), return_importance=True)
            full[impl] = (np.asarray(lg), np.asarray(imp), float(aux))
        built[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, toks=toks, pos=pos,
                           full=full,
                           tp=bridge.params_from_reference(jp, device="cpu"))
        return built[name]

    return get


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("name", MOE)
def test_forward_matches_reference(moe_models, name, impl):
    """Logits, importance and the summed aux loss of the full forward."""
    m = moe_models(name)
    tcfg = m["tcfg"].replace(attn_impl=impl)
    lg, cache, imp, aux = TM.forward(
        tcfg, m["tp"], torch.from_numpy(m["toks"]),
        torch.from_numpy(m["pos"].copy()), return_importance=True)
    want_lg, want_imp, want_aux = m["full"][impl]
    assert cache is None and lg.shape == (B, T + EXTRA, tcfg.vocab)
    np.testing.assert_allclose(lg.numpy(), want_lg, **MODEL_TOL)
    np.testing.assert_allclose(imp.numpy(), want_imp, **MODEL_TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("name", MOE)
def test_prefill_decode_matches_full_forward(moe_models, name, impl):
    """A cached prefill, then one-token decode steps, equal the
    reference's full forward at those positions."""
    m = moe_models(name)
    tcfg = m["tcfg"].replace(attn_impl=impl)
    tt = torch.from_numpy(m["toks"])
    cache = TM.init_cache(tcfg, B, T + EXTRA, device="cpu")
    assert set(cache) == ({"layers"} if tcfg.moe_every == 1
                          else {"dense", "moe"})
    lp, cache = TS.make_prefill_step(tcfg)(m["tp"], cache, tt[:, :T])
    np.testing.assert_allclose(lp.numpy(), m["full"]["blocked"][0][:, T - 1],
                               **MODEL_TOL)
    decode = TS.make_decode_step(tcfg)
    for t in range(T, T + EXTRA):
        ld, cache = decode(m["tp"], cache, tt[:, t:t + 1],
                           torch.full((B, 1), t, dtype=torch.int32))
        np.testing.assert_allclose(ld.numpy(), m["full"]["blocked"][0][:, t],
                                   **MODEL_TOL)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("name", MOE)
def test_verify_chunk_matches_reference(moe_models, name, impl):
    """A multi-token chunk over a cached prefix through the verify step
    equals the reference's verify step and its full forward."""
    m = moe_models(name)
    jcfg = m["jcfg"].replace(attn_impl=impl)
    tcfg = m["tcfg"].replace(attn_impl=impl)
    toks = m["toks"]
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    pos = m["pos"][:, T:].copy()
    jcache = JM.init_cache(jcfg, B, T + EXTRA)
    _, jcache = JS.make_prefill_step(jcfg)(m["jp"], jcache, jt[:, :T])
    jl, _ = JS.make_verify_step(jcfg)(m["jp"], jcache, jt[:, T:],
                                      jnp.asarray(pos))
    tcache = TM.init_cache(tcfg, B, T + EXTRA, device="cpu")
    _, tcache = TS.make_prefill_step(tcfg)(m["tp"], tcache, tt[:, :T])
    tl, _ = TS.make_verify_step(tcfg)(m["tp"], tcache, tt[:, T:],
                                      torch.from_numpy(pos))
    assert tl.shape == (B, EXTRA, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(tl.numpy(), m["full"]["blocked"][0][:, T:],
                               **MODEL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_init_params_layout_matches_reference(name, dtype):
    """The port's own random init has the reference's tree, shapes and
    dtypes (the router f32 whatever the model dtype)."""
    jcfg = ref_get_config(name).reduced().replace(dtype=dtype)
    tcfg = get_config(name).reduced().replace(dtype=dtype)
    want = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    got = TM.init_params(tcfg, seed=0, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path


# ---------------------------------------------------------------------------
# CloudEngine: the tiny pair with its LLM made MoE, dense and paged
# ---------------------------------------------------------------------------

MAX_NEW = 16
# (family fields of the tiny LLM, engine keyword arguments)
VARIANTS = {
    "dense": (dict(family="moe", n_layers=2, n_experts=4, top_k=2), {}),
    "paged": (dict(family="moe", n_layers=4, moe_every=2, n_experts=4,
                   top_k=1, n_shared_experts=1),
              dict(cache_impl="paged", block_size=16, share_prefix=True)),
}


def _prompts(seed):
    """Three prompts behind one 32-token common prefix (two full 16-token
    blocks a paged engine can share), and one of their own."""
    rng = np.random.default_rng(seed)
    common = [int(t) for t in rng.integers(1, 60, size=32)]
    shared = [common + [int(t) for t in rng.integers(1, 60, size=n)]
              for n in (3, 9, 14)]
    return shared + [[int(t) for t in rng.integers(1, 60, size=20)]]


@pytest.fixture(scope="module")
def engines():
    """Per variant, built once: the reference's dense SLM and MoE LLM
    (PRNGKey 0 / 1), their runs (``run_synera`` at concurrency 2, then
    ``run_cloud_centric``, on one reference engine) and the pool stats
    after each run."""
    built = {}

    def get(variant):
        if variant in built:
            return built[variant]
        fields, kw = VARIANTS[variant]
        slm, llm = tiny_pair(vocab=64)
        llm = llm.replace(**fields)
        slm_p = JM.init_params(slm, jax.random.PRNGKey(0))
        llm_p = JM.init_params(llm, jax.random.PRNGKey(1))
        dev = RefDevice(slm, slm_p, gamma=4, s_max=256,
                        policy=RefPolicy(mode="all"))
        eng = RefEngine(llm, llm_p, max_slots=4, s_max=256, **kw)
        prompts = _prompts(7)
        syn = RSY.run_synera(dev, eng, prompts, MAX_NEW, concurrency=2)
        pool1 = dict(eng.pool_stats)
        cc = RSY.run_cloud_centric(eng, prompts[:2], MAX_NEW)
        built[variant] = dict(
            fields=fields, kw=kw, prompts=prompts, synera=syn, cloud=cc,
            pools=(pool1, dict(eng.pool_stats)),
            t_slm_p=bridge.params_from_reference(
                jax.tree.map(np.asarray, slm_p), device="cpu"),
            t_llm_p=bridge.params_from_reference(
                jax.tree.map(np.asarray, llm_p), device="cpu"))
        return built[variant]

    return get


def _port_run(ref, impl, **engine_kw):
    slm, llm = port_tiny_pair(vocab=64)
    llm = llm.replace(**ref["fields"])
    if impl == "pallas":
        slm, llm = (slm.replace(attn_impl="pallas"),
                    llm.replace(attn_impl="pallas"))
    dev = DeviceRuntime(slm, ref["t_slm_p"], gamma=4, s_max=256,
                        policy=OffloadPolicy(mode="all"), device="cpu")
    eng = CloudEngine(llm, ref["t_llm_p"], max_slots=4, s_max=256,
                      device="cpu", **engine_kw)
    syn = SY.run_synera(dev, eng, ref["prompts"], MAX_NEW, concurrency=2)
    pool1 = dict(eng.pool_stats)
    cc = SY.run_cloud_centric(eng, ref["prompts"][:2], MAX_NEW)
    return eng, syn, cc, (pool1, dict(eng.pool_stats))


@pytest.mark.parametrize("impl", ["default", "pallas"])
@pytest.mark.parametrize("variant", ["dense", "paged"])
def test_engine_streams_identical(engines, variant, impl):
    ref = engines(variant)
    eng, syn, cc, pools = _port_run(ref, impl, **ref["kw"])
    assert syn.outputs == ref["synera"].outputs
    assert cc.outputs == ref["cloud"].outputs
    assert all(len(o) == MAX_NEW for o in syn.outputs + cc.outputs)
    assert sum(m.n_offloaded for m in syn.metrics) > 0
    for got, want in zip(pools, ref["pools"]):
        fields = POOL_FIELDS if variant == "paged" else tuple(want)
        for f in fields:
            assert got[f] == want[f], (f, got[f], want[f])
    if variant == "paged":
        assert set(eng.cache) == {"dense", "moe"}
        assert pools[0]["dedupe_hit_blocks"] > 0
        assert eng.allocator.used_blocks == 0


def test_interleaved_dense_cache_engine_matches_paged_reference(engines):
    """The ``{"dense", "moe"}`` cache on a dense engine (``reset_slot``
    walks both stacks between streams) serves the paged variant's model
    with the reference paged engine's streams."""
    ref = engines("paged")
    eng, syn, cc, _ = _port_run(ref, "pallas")
    assert set(eng.cache) == {"dense", "moe"}
    assert syn.outputs == ref["synera"].outputs
    assert cc.outputs == ref["cloud"].outputs


def test_reset_slot_and_kv_bytes_walk_every_stack():
    _, llm = port_tiny_pair(vocab=64)
    llm = llm.replace(**VARIANTS["paged"][0])
    eng = CloudEngine(llm, TM.init_params(llm, seed=3, device="cpu"),
                      max_slots=2, s_max=64, device="cpu")
    tokens = np.zeros((2, 8), np.int32)
    positions = np.full((2, 8), -1, np.int32)
    tokens[:, :5] = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]]
    positions[:, :5] = np.arange(5)
    eng.prefill(tokens, positions)
    for stack in ("dense", "moe"):
        assert (eng.cache[stack]["pos"][:, :, :5] >= 0).all()
    eng.reset_slot(0)
    for stack in ("dense", "moe"):
        pos = eng.cache[stack]["pos"]
        assert (pos[:, 0] == -1).all() and (pos[:, 1, :5] >= 0).all()
    rounds, nkv, hd = 2, llm.n_kv_heads, llm.head_dim
    per_stack = rounds * 2 * 64 * (2 * nkv * hd * 4 + 4)
    assert eng.kv_cache_bytes() == 2 * per_stack
    assert eng.pool_stats["kv_cache_bytes"] == 2 * per_stack


def test_bridge_keeps_router_float32():
    jcfg = ref_get_config("llama4-maverick-400b-a17b").reduced().replace(
        dtype="bfloat16")
    ref = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(2)))
    got = bridge.params_from_reference(ref, device="cpu",
                                       dtype=torch.bfloat16)
    moe = got["moe_layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  ref["moe_layers"]["moe"]["router"])
    for key in ("w_gate", "w_up", "w_down"):
        assert moe[key].dtype == torch.bfloat16, key
        assert moe["shared"][key].dtype == torch.bfloat16, key
    assert got["dense_layers"]["mlp"]["w_gate"].dtype == torch.bfloat16
