"""The reference's dense configs in the port, against the reference.

``glm4-9b``, ``llama3.2-1b``, ``qwen2-1.5b`` and ``qwen1.5-110b`` (and
the configs of ``zamba2-2.7b``, ``llama-3.2-vision-90b`` and
``whisper-medium``, whose models are ``tests/test_torch_hybrid.py``'s,
``test_torch_vlm.py``'s and ``test_torch_audio.py``'s) are copies of
the reference's files: every field and the parameter count must agree,
full size and ``reduced()``.  Each dense config's reduced
model (2 layers, d_model 256, GQA g = 2, head dim 64; its QKV bias and
tied embeddings as published) runs through both packages on the CPU in
float32 with the reference's own weights (through ``repro_torch.bridge``)
under ``attn_impl="blocked"`` and ``"pallas"``: the reference's Pallas
kernels in interpret mode, the port's kernel wrappers on their plain
versions.  The engine is not rebuilt here: the dense family is already
held against the reference's engine on the tiny pair.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import model as JM
from repro.models import steps as JS
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import steps as TS

DENSE = ["glm4-9b", "llama3.2-1b", "qwen2-1.5b", "qwen1.5-110b"]
# parameter counts of the full configs (the reference's param_count, in B)
PARAMS_B = {"glm4-9b": 9.40, "llama3.2-1b": 1.236, "qwen2-1.5b": 1.544,
            "qwen1.5-110b": 111.21, "zamba2-2.7b": 2.422,
            "llama-3.2-vision-90b": 87.67, "whisper-medium": 1.012}
# f32 through 2 layers and a 1024-way unembedding, the two packages
# summing in other orders (XLA vs PyTorch CPU kernels)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
B, T, EXTRA = 2, 20, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", DENSE + ["zamba2-2.7b",
                                  "llama-3.2-vision-90b", "whisper-medium"])
def test_config_matches_reference(name, reduced):
    ref, got = ref_get_config(name), get_config(name)
    if reduced:
        ref, got = ref.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.param_count() == ref.param_count()
    if not reduced:
        assert abs(got.param_count() / 1e9 - PARAMS_B[name]) < 5e-3 * \
            PARAMS_B[name]


@pytest.fixture(scope="module")
def dense_models():
    """Per config, built once: reduced configs of both packages, the
    reference's weights (with seeded noise on the QKV biases, which init
    to zero) and both packages' views of them, the tokens, and the
    reference's full forward under each attention implementation."""
    built = {}

    def get(name):
        if name in built:
            return built[name]
        jcfg = ref_get_config(name).reduced()
        tcfg = get_config(name).reduced()
        jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
        rng = np.random.default_rng(20)
        attn = jp["layers"]["attn"]
        for key in ("bq", "bk", "bv"):
            if key in attn:
                attn[key] = (rng.standard_normal(attn[key].shape)
                             * 0.1).astype(attn[key].dtype)
        toks = rng.integers(0, jcfg.vocab, (B, T + EXTRA))
        pos = np.broadcast_to(np.arange(T + EXTRA, dtype=np.int32),
                              (B, T + EXTRA))
        full = {impl: np.asarray(JM.forward(
            jcfg.replace(attn_impl=impl), jp, jnp.asarray(toks, jnp.int32),
            jnp.asarray(pos))[0]) for impl in ("blocked", "pallas")}
        built[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, toks=toks, pos=pos,
                           full=full,
                           tp=bridge.params_from_reference(jp, device="cpu"))
        return built[name]

    return get


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("name", DENSE)
def test_forward_logits_match(dense_models, name, impl):
    m = dense_models(name)
    tcfg = m["tcfg"].replace(attn_impl=impl)
    assert ("bq" in m["tp"]["layers"]["attn"]) == tcfg.qkv_bias
    assert ("unembed" in m["tp"]) != tcfg.tie_embeddings
    tl = TM.forward(tcfg, m["tp"], torch.from_numpy(m["toks"]),
                    torch.from_numpy(m["pos"].copy()))[0]
    assert tl.shape == (B, T + EXTRA, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), m["full"][impl], **MODEL_TOL)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_decode_matches_full_forward(dense_models, name, impl):
    """As tests/test_models.py:73: a cached prefill, then one-token decode
    steps, equal the reference's full forward at those positions."""
    m = dense_models(name)
    tcfg = m["tcfg"].replace(attn_impl=impl)
    tt = torch.from_numpy(m["toks"])
    cache = TM.init_cache(tcfg, B, T + EXTRA, device="cpu")
    lp, cache = TS.make_prefill_step(tcfg)(m["tp"], cache, tt[:, :T])
    np.testing.assert_allclose(lp.numpy(), m["full"]["blocked"][:, T - 1],
                               **MODEL_TOL)
    decode = TS.make_decode_step(tcfg)
    for t in range(T, T + EXTRA):
        ld, cache = decode(m["tp"], cache, tt[:, t:t + 1],
                           torch.full((B, 1), t, dtype=torch.int32))
        np.testing.assert_allclose(ld.numpy(), m["full"]["blocked"][:, t],
                                   **MODEL_TOL)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
@pytest.mark.parametrize("name", DENSE)
def test_verify_chunk_matches_full_forward(dense_models, name, impl):
    """As tests/test_models.py:97: a multi-token chunk over a cached prefix
    through the verify step equals the full forward, and the reference's
    verify step."""
    m = dense_models(name)
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
    np.testing.assert_allclose(tl.numpy(), m["full"]["blocked"][:, T:],
                               **MODEL_TOL)
