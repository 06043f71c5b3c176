"""Port of the vlm family against the reference, on the CPU.

``llama-3.2-vision-90b`` is a copy of the reference's config file.  Its
reduced model (two rounds, each one dense self-attention layer then one
gated cross-attention layer over projected image embeddings) runs through
both packages in float32 with the reference's own weights (through
``repro_torch.bridge``) under ``attn_impl="blocked"`` and ``"pallas"``
(the reference's Pallas kernels in interpret mode, the port's wrappers on
their plain versions): the forward with image embeds, a prefill with them
then decode steps and a verify chunk over the cross cache the prefill
wrote.  The cross layers' tanh gates initialise to zero, which makes
every cross layer a no-op, so the weights here carry gates of 0.5 in
both packages.  The tiny pair's LLM made vlm is served by both
packages' dense engines (whose steps never fill the cross cache, as the
reference serves the family): the ``run_cloud_centric`` streams must be
identical.

The helpers here also serve ``tests/test_torch_audio.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs.synera_pair import tiny_pair
from repro.models import model as JM
from repro.models import steps as JS
from repro.serving import synergy as RSY
from repro.serving.engine import CloudEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.models import model as TM
from repro_torch.models import steps as TS
from repro_torch.serving import synergy as SY
from repro_torch.serving.engine import CloudEngine

NAME = "llama-3.2-vision-90b"
# f32 through 4 layers and a 1024-way unembedding, the two packages
# summing in other orders (XLA vs PyTorch CPU kernels)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
B, T, EXTRA = 2, 20, 4
GATE = 0.5                 # the vlm's cross-layer gates in these tests
MAX_NEW = 12
# the tiny LLM made vlm (two rounds of a self and a cross layer) and made
# audio (two encoder and two decoder layers)
TINY_FIELDS = {
    "vlm": dict(family="vlm", n_layers=4, cross_attn_every=2,
                n_image_tokens=8),
    "audio": dict(family="audio", n_layers=2, n_encoder_layers=2,
                  n_audio_frames=12),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Helpers shared with tests/test_torch_audio.py
# ---------------------------------------------------------------------------

def aux_key(cfg) -> str:
    return TM.AUX_INPUTS[cfg.family]


def aux_array(cfg, batch, seed) -> np.ndarray:
    """Stub frontend output from a numpy seed: the vlm's image embeds
    (B, n_image_tokens, vision_dim), the audio family's frames (B,
    n_audio_frames, d_model), float32."""
    src = (cfg.n_image_tokens, cfg.vision_dim) if cfg.family == "vlm" \
        else (cfg.n_audio_frames, cfg.d_model)
    return np.random.default_rng(seed).standard_normal(
        (batch, *src)).astype(np.float32)


def ref_params(cfg, seed, gate=GATE):
    """The reference's parameters as writable numpy arrays; a vlm's
    cross-layer gates set to ``gate``."""
    tree = jax.tree.map(np.array, JM.init_params(cfg,
                                                 jax.random.PRNGKey(seed)))
    if cfg.family == "vlm":
        for key in ("gate_attn", "gate_ffn"):
            tree["cross_layers"][key][:] = gate
    return tree


def build_model(name):
    """Reduced configs of both packages, the reference's weights (gates
    0.5) and the port's view of them, tokens, positions, the aux input,
    and the reference's full forward (logits, importance) under each
    attention implementation."""
    jcfg = ref_get_config(name).reduced()
    tcfg = get_config(name).reduced()
    jp = ref_params(jcfg, 0)
    toks = np.random.default_rng(21).integers(0, jcfg.vocab, (B, T + EXTRA))
    pos = np.broadcast_to(np.arange(T + EXTRA, dtype=np.int32),
                          (B, T + EXTRA)).copy()
    aux = aux_array(jcfg, B, 5)
    full = {}
    for impl in ("blocked", "pallas"):
        lg, _, imp, _ = JM.forward(
            jcfg.replace(attn_impl=impl), jp, jnp.asarray(toks, jnp.int32),
            jnp.asarray(pos), aux_inputs={aux_key(jcfg): jnp.asarray(aux)},
            return_importance=True)
        full[impl] = (np.asarray(lg), np.asarray(imp))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, toks=toks, pos=pos, aux=aux,
                full=full, tp=bridge.params_from_reference(jp, device="cpu"))


def check_forward(m, impl):
    tcfg = m["tcfg"].replace(attn_impl=impl)
    lg, cache, imp, _ = TM.forward(
        tcfg, m["tp"], torch.from_numpy(m["toks"]), torch.from_numpy(m["pos"]),
        aux_inputs={aux_key(tcfg): torch.from_numpy(m["aux"])},
        return_importance=True)
    want_lg, want_imp = m["full"][impl]
    assert cache is None and lg.shape == (B, T + EXTRA, tcfg.vocab)
    assert imp.shape == (B, T + EXTRA)
    np.testing.assert_allclose(lg.numpy(), want_lg, **MODEL_TOL)
    np.testing.assert_allclose(imp.numpy(), want_imp, **MODEL_TOL)


def check_prefill_decode(m, impl):
    """A prefill with the aux input (which fills the cross cache), then
    one-token decode steps over it, equal the reference's same steps and
    the port's own full forward at those positions."""
    jcfg = m["jcfg"].replace(attn_impl=impl)
    tcfg = m["tcfg"].replace(attn_impl=impl)
    key, toks = aux_key(tcfg), m["toks"]
    jt = jnp.asarray(toks, jnp.int32)
    jcache = JM.init_cache(jcfg, B, T + EXTRA)
    jl, jcache = JS.make_prefill_step(jcfg)(
        m["jp"], jcache, jt[:, :T], {key: jnp.asarray(m["aux"])})
    want = [np.asarray(jl)]
    jdecode = JS.make_decode_step(jcfg)
    for t in range(T, T + EXTRA - 1):
        jl, jcache = jdecode(m["jp"], jcache, jt[:, t:t + 1],
                             jnp.full((B, 1), t, jnp.int32))
        want.append(np.asarray(jl))

    tt = torch.from_numpy(toks)
    own, _, _, _ = TM.forward(tcfg, m["tp"], tt, torch.from_numpy(m["pos"]),
                              aux_inputs={key: torch.from_numpy(m["aux"])})
    cache = TM.init_cache(tcfg, B, T + EXTRA, device="cpu")
    assert set(cache) == {"self", "cross"}
    lp, cache = TS.make_prefill_step(tcfg)(
        m["tp"], cache, tt[:, :T], {key: torch.from_numpy(m["aux"])})
    got = [lp]
    assert bool(cache["cross"]["k"].abs().sum() > 0)
    decode = TS.make_decode_step(tcfg)
    for t in range(T, T + EXTRA - 1):
        ld, cache = decode(m["tp"], cache, tt[:, t:t + 1],
                           torch.full((B, 1), t, dtype=torch.int32))
        got.append(ld)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL)
        np.testing.assert_allclose(g.numpy(), own[:, T - 1 + i].numpy(),
                                   **MODEL_TOL)


def check_verify_chunk(m, impl):
    """A multi-token chunk over a cached prefix through the verify step
    (no aux input: it reads the cross cache the prefill wrote, and leaves
    it as it was) equals the reference's verify step and its full
    forward (``tests/test_models.py``'s oracle)."""
    jcfg = m["jcfg"].replace(attn_impl=impl)
    tcfg = m["tcfg"].replace(attn_impl=impl)
    key, toks = aux_key(tcfg), m["toks"]
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    pos = m["pos"][:, T:].copy()
    jcache = JM.init_cache(jcfg, B, T + EXTRA)
    _, jcache = JS.make_prefill_step(jcfg)(m["jp"], jcache, jt[:, :T],
                                           {key: jnp.asarray(m["aux"])})
    jl, _ = JS.make_verify_step(jcfg)(m["jp"], jcache, jt[:, T:],
                                      jnp.asarray(pos))
    tcache = TM.init_cache(tcfg, B, T + EXTRA, device="cpu")
    _, tcache = TS.make_prefill_step(tcfg)(m["tp"], tcache, tt[:, :T],
                                           {key: torch.from_numpy(m["aux"])})
    cross = {k: v.clone() for k, v in tcache["cross"].items()}
    tl, tcache = TS.make_verify_step(tcfg)(m["tp"], tcache, tt[:, T:],
                                           torch.from_numpy(pos))
    assert tl.shape == (B, EXTRA, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(tl.numpy(), m["full"]["blocked"][0][:, T:],
                               **MODEL_TOL)
    for k in ("k", "v"):
        assert torch.equal(tcache["cross"][k], cross[k]), k


def _leaves(tree):
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def check_layouts(name, dtype):
    """The port's own random init and its cache have the reference's
    trees, shapes and dtypes (the cross stacks included)."""
    jcfg = ref_get_config(name).reduced().replace(dtype=dtype)
    tcfg = get_config(name).reduced().replace(dtype=dtype)
    pairs = (
        (jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))),
         TM.init_params(tcfg, seed=0, device="cpu")),
        (jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 16)),
         TM.init_cache(tcfg, 3, 16, device="cpu")))
    for want, got in pairs:
        w, g = _leaves(want), _leaves(got)
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, wl), (_, gl) in zip(w, g):
            assert tuple(gl.shape) == wl.shape, path
            assert str(gl.dtype) == f"torch.{wl.dtype}", path
    return TM.init_params(tcfg, seed=0, device="cpu")


def check_bridge_bf16(name):
    """A bf16 reference tree crosses the bridge leaf for leaf, values and
    dtypes kept."""
    jcfg = ref_get_config(name).reduced().replace(dtype="bfloat16")
    ref = ref_params(jcfg, 2)
    got = bridge.params_from_reference(ref, device="cpu",
                                       dtype=torch.bfloat16)
    r, g = _leaves(ref), _leaves(got)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, rl), (_, gl) in zip(r, g):
        assert gl.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(gl.float().numpy(),
                                      np.asarray(rl, np.float32))


def check_refusals(name):
    """Paged caches are refused for the family (the model and the
    engine), as is a forward with neither a cache nor the aux input, and
    an aux input in another dtype than the model's."""
    cfg = get_config(name).reduced()
    with pytest.raises(ValueError, match="paged"):
        TM.init_cache(cfg, 2, 32, cache_impl="paged", device="cpu")
    params = TM.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        CloudEngine(cfg, params, max_slots=2, s_max=32, cache_impl="paged",
                    block_size=16, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    pos = TM.default_positions(1, 4, device="cpu")
    with pytest.raises(ValueError, match="neither"):
        TM.forward(cfg, params, toks, pos)
    aux = torch.from_numpy(aux_array(cfg, 1, 0)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        TM.forward(cfg, params, toks, pos, aux_inputs={aux_key(cfg): aux})


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 60, size=n)] for n in (7, 19)]


def reference_engine_run(family):
    """The reference's dense engine for the tiny LLM made ``family``
    (PRNGKey 1, gates 0.5): ``run_cloud_centric`` outputs and
    ``kv_cache_bytes``."""
    _, llm = tiny_pair(vocab=64)
    llm = llm.replace(**TINY_FIELDS[family])
    llm_p = ref_params(llm, 1)
    eng = RefEngine(llm, llm_p, max_slots=2, s_max=64)
    prompts = _prompts(9)
    cc = RSY.run_cloud_centric(eng, prompts, MAX_NEW)
    return dict(prompts=prompts, outputs=cc.outputs,
                kv_bytes=eng.kv_cache_bytes(),
                t_llm_p=bridge.params_from_reference(llm_p, device="cpu"))


def port_engine(family, params, impl="blocked"):
    _, llm = port_tiny_pair(vocab=64)
    llm = llm.replace(**TINY_FIELDS[family], attn_impl=impl)
    return CloudEngine(llm, params, max_slots=2, s_max=64, device="cpu")


def check_engine_streams(ref, family, impl):
    eng = port_engine(family, ref["t_llm_p"], impl)
    assert set(eng.cache) == {"self", "cross"}
    cc = SY.run_cloud_centric(eng, ref["prompts"], MAX_NEW)
    assert cc.outputs == ref["outputs"]
    assert all(len(o) == MAX_NEW for o in cc.outputs)


def check_reset_slot_and_kv_bytes(ref, family):
    """``reset_slot`` invalidates the slot's positions in every self
    stack and leaves the cross stacks (no positions) alone;
    ``kv_cache_bytes`` counts both, as the reference engine's does."""
    eng = port_engine(family, ref["t_llm_p"])
    tokens = np.zeros((2, 8), np.int32)
    positions = np.full((2, 8), -1, np.int32)
    tokens[:, :5] = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]]
    positions[:, :5] = np.arange(5)
    eng.prefill(tokens, positions)
    pos = eng.cache["self"]["pos"]
    assert (pos[..., :, :5] >= 0).all()
    cross = {k: v.clone() for k, v in eng.cache["cross"].items()}
    eng.reset_slot(0)
    assert (pos[..., 0, :] == -1).all() and (pos[..., 1, :5] >= 0).all()
    for k in ("k", "v"):
        assert torch.equal(eng.cache["cross"][k], cross[k]), k
    assert eng.kv_cache_bytes() == ref["kv_bytes"]
    assert eng.pool_stats["kv_cache_bytes"] == ref["kv_bytes"]


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm_model():
    return build_model(NAME)


@pytest.fixture(scope="module")
def vlm_engine():
    return reference_engine_run("vlm")


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_forward_matches_reference(vlm_model, impl):
    check_forward(vlm_model, impl)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_prefill_decode_matches_reference(vlm_model, impl):
    check_prefill_decode(vlm_model, impl)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_verify_chunk_matches_reference(vlm_model, impl):
    check_verify_chunk(vlm_model, impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_match_reference_layout(dtype):
    params = check_layouts(NAME, dtype)
    cfg = get_config(NAME).reduced()
    rounds = cfg.n_layers // cfg.cross_attn_every
    assert params["self_layers"]["attn"]["wq"].shape[:2] == (
        rounds, cfg.cross_attn_every - 1)
    for key in ("gate_attn", "gate_ffn"):
        gate = params["cross_layers"][key]
        assert gate.shape == (rounds, 1) and not gate.any(), key


def test_bridge_keeps_every_leaf():
    check_bridge_bf16(NAME)


def test_paged_cache_and_missing_inputs_refused():
    check_refusals(NAME)


def test_gates_are_live(vlm_model):
    """At gate 0 the cross layers change nothing (other image embeds give
    the same logits, bit for bit); at 0.5 they do."""
    m = vlm_model
    tcfg = m["tcfg"]
    toks, pos = torch.from_numpy(m["toks"]), torch.from_numpy(m["pos"])
    images = [torch.from_numpy(aux_array(tcfg, B, s)) for s in (1, 2)]
    shut = bridge.params_from_reference(ref_params(m["jcfg"], 0, gate=0.0),
                                        device="cpu")
    diff = {}
    for label, params in (("shut", shut), ("live", m["tp"])):
        lg = [TM.forward(tcfg, params, toks, pos,
                         aux_inputs={"image_embeds": x})[0] for x in images]
        diff[label] = float((lg[0] - lg[1]).abs().max())
    assert diff["shut"] == 0.0 and diff["live"] > 1e-3, diff


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_engine_streams_identical(vlm_engine, impl):
    check_engine_streams(vlm_engine, "vlm", impl)


def test_reset_slot_and_kv_bytes_walk_self_and_cross(vlm_engine):
    check_reset_slot_and_kv_bytes(vlm_engine, "vlm")
