"""Port model layer against the reference: weight bridge, forward with a
dense cache, cache writes, the fused verification epilogue and the device
draft step.  Both packages run on the CPU in float32 on the tiny pair;
the port's weights are the reference's own, through ``repro_torch.bridge``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import io as ckpt_io
from repro.configs.synera_pair import tiny_pair
from repro.models import model as JM
from repro.models import steps as JS
from repro.serving.device import _make_device_step as ref_device_step
from repro_torch import bridge
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import steps as TS
from repro_torch.serving.device import _make_device_step as port_device_step

ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    slm, llm = tiny_pair(vocab=64)
    slm_p = jax.tree.map(np.asarray, JM.init_params(slm, jax.random.PRNGKey(0)))
    llm_p = jax.tree.map(np.asarray, JM.init_params(llm, jax.random.PRNGKey(1)))
    pslm, pllm = port_tiny_pair(vocab=64)
    return dict(slm=slm, llm=llm, slm_p=slm_p, llm_p=llm_p, pslm=pslm,
                pllm=pllm,
                t_slm_p=bridge.params_from_reference(slm_p, device="cpu"),
                t_llm_p=bridge.params_from_reference(llm_p, device="cpu"))


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_round_trip(pair, tmp_path):
    back = bridge.params_to_reference(pair["t_llm_p"])
    ref = dict(_leaves(pair["llm_p"]))
    got = dict(_leaves(back))
    assert ref.keys() == got.keys()
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key])
    # a checkpoint/io.py .npz (flat ``||`` keys) bridges to the same tree
    path = tmp_path / "llm.npz"
    ckpt_io.save(str(path), pair["llm_p"])
    from_npz = bridge.params_from_reference(dict(np.load(path)), device="cpu")
    for key, t in _leaves(from_npz):
        np.testing.assert_array_equal(t.numpy(), ref[key])


def test_bridge_keeps_bfloat16_bits():
    slm, _ = tiny_pair(vocab=64)
    cfg = slm.replace(dtype="bfloat16")
    ref = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(3)))
    got = bridge.params_from_reference(ref, device="cpu")
    w = got["layers"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy(),
        ref["layers"]["attn"]["wq"].view(np.int16))


def test_init_params_matches_reference_layout(pair):
    ref = jax.eval_shape(lambda k: JM.init_params(pair["llm"], k),
                         jax.random.PRNGKey(0))
    got = TM.init_params(pair["pllm"], seed=0, device="cpu")
    ref_leaves = {k: v for k, v in _leaves(ref)}
    got_leaves = {k: v for k, v in _leaves(got)}
    assert ref_leaves.keys() == got_leaves.keys()
    for key, r in ref_leaves.items():
        assert tuple(got_leaves[key].shape) == r.shape, key
        assert str(got_leaves[key].dtype) == f"torch.{r.dtype}", key
    # same scales as the reference's initializer
    emb = got["embed"].float()
    assert abs(float(emb.std()) - 0.02) < 2e-3
    assert (got["layers"]["ln1"] == 1).all()


def _steps():
    """(tokens, positions) for three forwards over a 2-slot cache:
    a ragged prompt chunk, a decode step, a padded verify chunk."""
    rng = np.random.default_rng(5)
    t1 = rng.integers(0, 64, (2, 8)).astype(np.int32)
    p1 = np.stack([np.arange(8), np.r_[np.arange(5), [-1] * 3]]).astype(
        np.int32)
    t2 = rng.integers(0, 64, (2, 1)).astype(np.int32)
    p2 = np.array([[8], [5]], np.int32)
    t3 = rng.integers(0, 64, (2, 4)).astype(np.int32)
    p3 = np.array([[9, 10, 11, 12], [6, 7, -1, -1]], np.int32)
    return [(t1, p1), (t2, p2), (t3, p3)]


@pytest.mark.parametrize("impl", ["naive", "blocked", "pallas"])
def test_forward_with_dense_cache_matches(pair, impl):
    jcfg = pair["llm"].replace(attn_impl=impl, attn_block_kv=16)
    tcfg = pair["pllm"].replace(attn_impl=impl, attn_block_kv=16)
    jcache = JM.init_cache(jcfg, 2, 32)
    tcache = TM.init_cache(tcfg, 2, 32, device="cpu")
    for tokens, pos in _steps():
        jl, jcache, _, _ = JM.forward(jcfg, pair["llm_p"], jnp.asarray(tokens),
                                      jnp.asarray(pos), cache=jcache)
        tl, tcache, _, _ = TM.forward(tcfg, pair["t_llm_p"],
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(pos), cache=tcache)
        valid = pos >= 0
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   atol=ATOL, rtol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]),
                                   atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(tcache["layers"]["pos"].numpy(),
                                  np.asarray(jcache["layers"]["pos"]))


def test_forward_without_cache_matches(pair):
    """The cache-free path (the device's perplexity) over the kernels."""
    cfg, tcfg = pair["slm"].replace(attn_impl="pallas"), pair["pslm"].replace(
        attn_impl="pallas")
    tokens = np.random.default_rng(6).integers(0, 64, (1, 12)).astype(np.int32)
    pos = np.arange(12, dtype=np.int32)[None]
    jl = JM.forward(cfg, pair["slm_p"], jnp.asarray(tokens),
                    jnp.asarray(pos))[0]
    tl = TM.forward(tcfg, pair["t_slm_p"], torch.from_numpy(tokens).long(),
                    torch.from_numpy(pos))[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)


def test_cache_write_drops_padding():
    cache = {"k": torch.randn(2, 8, 1, 4), "v": torch.randn(2, 8, 1, 4),
             "pos": torch.full((2, 8), -1, dtype=torch.int32)}
    before = {k: v.clone() for k, v in cache.items()}
    new = torch.randn(2, 3, 1, 4)
    TL.cache_write(cache, new, new, torch.full((2, 3), -1, dtype=torch.int32))
    for key in cache:
        assert torch.equal(cache[key], before[key]), key
    # mixed: only the valid rows land, at positions % s_max
    pos = torch.tensor([[3, -1, 9], [-1, -1, 0]], dtype=torch.int32)
    TL.cache_write(cache, new, new * 2, pos)
    assert torch.equal(cache["k"][0, 3], new[0, 0])
    assert torch.equal(cache["k"][0, 1], new[0, 2])          # 9 % 8
    assert torch.equal(cache["v"][1, 0], new[1, 2] * 2)
    assert cache["pos"][0].tolist() == [-1, 9, -1, 3, -1, -1, -1, -1]
    assert cache["pos"][1].tolist() == [0] + [-1] * 7
    untouched = [(0, 0), (0, 2), (1, 1), (1, 5)]
    for b, s in untouched:
        assert torch.equal(cache["k"][b, s], before["k"][b, s])


@pytest.mark.parametrize("with_dists", [True, False])
def test_fused_verify_epilogue_matches(with_dists):
    rng = np.random.default_rng(7)
    B, C, V, R, K = 3, 6, 16, 4, 5
    logits = rng.standard_normal((B, C, V)).astype(np.float32)
    logits[0, 1, [2, 9]] = logits[0, 1].max() + 1.0   # tie on the argmax
    logits[1, 0, [4, 5]] = logits[1, 0].max() + 0.5   # tie inside the top-k
    targets = rng.integers(-1, V, (B, C)).astype(np.int32)
    sel = np.array([[0, 1, 2, -1], [0, 3, 4, 5], [-1, -1, -1, -1]], np.int32)
    ref = JS.fused_verify_epilogue(jnp.asarray(logits), jnp.asarray(targets),
                                   jnp.asarray(sel), K, with_dists=with_dists)
    got = TS.fused_verify_epilogue(torch.from_numpy(logits),
                                   torch.from_numpy(targets),
                                   torch.from_numpy(sel), K,
                                   with_dists=with_dists)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-6)
    # tie order inside the top-k may differ between frameworks: compare
    # each row's support as a set, values sorted
    for b in range(B):
        for r in range(R):
            assert (set(got[2][b, r].tolist())
                    == set(np.asarray(ref[2])[b, r].tolist()))


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_device_step_matches(pair, impl):
    """Per-layer logits (in the model dtype) and the importance vector of
    the device SLM's one-token step, after a prompt feed."""
    cfg = pair["slm"].replace(attn_impl=impl)
    tcfg = pair["pslm"].replace(attn_impl=impl)
    prompt = np.array([[3, 1, 4, 1, 5, 9, 2]], np.int32)
    pos = np.arange(7, dtype=np.int32)[None]
    jcache = JM.init_cache(cfg, 1, 32)
    _, jcache, _, _ = JM.forward(cfg, pair["slm_p"], jnp.asarray(prompt),
                                 jnp.asarray(pos), cache=jcache)
    tcache = TM.init_cache(tcfg, 1, 32, device="cpu")
    TM.forward(tcfg, pair["t_slm_p"], torch.from_numpy(prompt).long(),
               torch.from_numpy(pos), cache=tcache)
    jstep, tstep = ref_device_step(cfg), port_device_step(tcfg)
    for t, p in ((6, 7), (8, 8)):
        jl, ji, jcache = jstep(pair["slm_p"], jcache,
                               jnp.asarray([[t]], jnp.int32),
                               jnp.asarray([[p]], jnp.int32))
        tl, ti, tcache = tstep(pair["t_slm_p"], tcache,
                               torch.tensor([[t]]),
                               torch.tensor([[p]], dtype=torch.int32))
        assert tl.shape == (cfg.n_layers, cfg.vocab) and ti.shape == (32,)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6)
        assert abs(float(ti.sum()) - 1.0) < 1e-5   # one query row


def test_prefill_and_draft_steps_match(pair):
    """The prompt-prefill step (last-row logits) and the device draft step
    (logits + importance) against the reference's step factories."""
    cfg = pair["slm"].replace(attn_impl="pallas")
    tcfg = pair["pslm"].replace(attn_impl="pallas")
    tokens = np.random.default_rng(8).integers(0, 64, (2, 6)).astype(np.int32)
    jl, jcache = JS.make_prefill_step(cfg)(pair["slm_p"],
                                           JM.init_cache(cfg, 2, 16),
                                           jnp.asarray(tokens))
    tcache = TM.init_cache(tcfg, 2, 16, device="cpu")
    tl, tcache = TS.make_prefill_step(tcfg)(pair["t_slm_p"], tcache,
                                            torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    tok = np.array([[7], [9]], np.int32)
    pos = np.array([[6], [6]], np.int32)
    jd = JS.make_device_draft_step(cfg)(pair["slm_p"], jcache,
                                        jnp.asarray(tok), jnp.asarray(pos))
    td = TS.make_device_draft_step(tcfg)(pair["t_slm_p"], tcache,
                                         torch.from_numpy(tok).long(),
                                         torch.from_numpy(pos))
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd[0]), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(td[2].numpy(), np.asarray(jd[2]), atol=1e-6)
