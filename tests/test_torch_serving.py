"""Port serving stack against the reference, end to end on the CPU.

The quickstart setup (``examples/quickstart.py``: the tiny pair at vocab
64, PRNGKey 0/1 weights, its prompts and offload policy) runs through
both packages with the reference's weights bridged into the port.  Greedy
token streams must be byte-identical and the device counters equal.  The
port runs once with its default attention paths and once through the
kernels' dispatch (``attn_impl="pallas"``, whose plain versions run on
the CPU).  One reference engine and device runtime are built per module.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.synera_pair import tiny_pair
from repro.core.offload import OffloadPolicy as RefPolicy
from repro.models import model as JM
from repro.serving import synergy as RSY
from repro.serving.device import DeviceRuntime as RefDevice
from repro.serving.engine import CloudEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.core.offload import OffloadPolicy
from repro_torch.serving import synergy as SY
from repro_torch.serving.device import DeviceRuntime
from repro_torch.serving.engine import CloudEngine

PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1]]
MAX_NEW = 24
COUNTERS = ("n_chunks", "n_offloaded", "n_draft_tokens", "n_accepted_tokens",
            "n_cloud_tokens", "n_cloud_fed_tokens", "n_local_tokens",
            "pi_position_hits", "pi_adopted", "uplink_bytes",
            "downlink_bytes")
POLICIES = {"quickstart": dict(c_th=0.8, i_th=0.04, mode="both"),
            "all": dict(mode="all")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    slm, llm = tiny_pair(vocab=64)
    slm_p = JM.init_params(slm, jax.random.PRNGKey(0))
    llm_p = JM.init_params(llm, jax.random.PRNGKey(1))
    return dict(
        slm=slm, llm=llm, slm_p=slm_p, llm_p=llm_p,
        t_slm_p=bridge.params_from_reference(
            jax.tree.map(np.asarray, slm_p), device="cpu"),
        t_llm_p=bridge.params_from_reference(
            jax.tree.map(np.asarray, llm_p), device="cpu"))


@pytest.fixture(scope="module")
def reference(weights):
    """One reference engine (jit once), its runs memoised by key."""
    eng = RefEngine(weights["llm"], weights["llm_p"], max_slots=4, s_max=256)
    devs = {name: RefDevice(weights["slm"], weights["slm_p"], gamma=4,
                            s_max=256, policy=RefPolicy(**pol))
            for name, pol in POLICIES.items()}
    memo = {}

    def run(key):
        if key not in memo:
            kind, policy, conc = key
            if policy is not None:
                # the device's PI / sampling rng is per instance: restart
                # it so every run starts where a fresh port device does
                devs[policy].rng = np.random.default_rng(devs[policy].seed)
            if kind == "synera":
                memo[key] = RSY.run_synera(devs[policy], eng, PROMPTS,
                                           MAX_NEW, concurrency=conc)
            elif kind == "sample":
                memo[key] = RSY.run_synera(devs[policy], eng, PROMPTS,
                                           MAX_NEW, sampling="sample")
            elif kind == "edge":
                memo[key] = RSY.run_edge_centric(devs[policy], PROMPTS,
                                                 MAX_NEW)
            else:
                memo[key] = RSY.run_cloud_centric(eng, PROMPTS, MAX_NEW)
        return memo[key]

    run.engine = eng
    return run


def _port(weights, impl, policy="quickstart"):
    slm, llm = port_tiny_pair(vocab=64)
    if impl == "pallas":
        slm, llm = (slm.replace(attn_impl="pallas"),
                    llm.replace(attn_impl="pallas"))
    dev = DeviceRuntime(slm, weights["t_slm_p"], gamma=4, s_max=256,
                        policy=OffloadPolicy(**POLICIES[policy]),
                        device="cpu")
    eng = CloudEngine(llm, weights["t_llm_p"], max_slots=4, s_max=256,
                      device="cpu")
    return dev, eng


def _assert_same_run(got, ref):
    assert got.outputs == ref.outputs
    for mg, mr in zip(got.metrics, ref.metrics):
        for c in COUNTERS:
            assert getattr(mg, c) == getattr(mr, c), c
        assert mg.timeline.t_ms == pytest.approx(mr.timeline.t_ms)


@pytest.mark.parametrize("impl", ["default", "pallas"])
@pytest.mark.parametrize("policy,concurrency", [
    ("quickstart", 1), ("quickstart", 2), ("all", 1), ("all", 2)])
def test_run_synera_identical(weights, reference, impl, policy, concurrency):
    dev, eng = _port(weights, impl, policy)
    got = SY.run_synera(dev, eng, PROMPTS, MAX_NEW, concurrency=concurrency)
    ref = reference(("synera", policy, concurrency))
    _assert_same_run(got, ref)
    sched, rsched = got.extras["scheduler"], ref.extras["scheduler"]
    for key in ("iterations", "prefill_iterations", "verify_iterations",
                "mean_verify_occupancy", "sim_ms"):
        assert sched[key] == pytest.approx(rsched[key]), key


def test_run_synera_sampling_identical(weights, reference):
    """Stochastic verification (top-k supports, seeded rngs) reproduces
    the reference's draws."""
    dev, eng = _port(weights, "pallas", "all")
    got = SY.run_synera(dev, eng, PROMPTS, MAX_NEW, sampling="sample")
    _assert_same_run(got, reference(("sample", "all", 1)))


@pytest.mark.parametrize("impl", ["default", "pallas"])
def test_run_cloud_centric_identical(weights, reference, impl):
    _, eng = _port(weights, impl)
    got = SY.run_cloud_centric(eng, PROMPTS, MAX_NEW)
    _assert_same_run(got, reference(("cloud", None, 1)))


@pytest.mark.parametrize("impl", ["default", "pallas"])
def test_run_edge_centric_identical(weights, reference, impl):
    dev, _ = _port(weights, impl)
    got = SY.run_edge_centric(dev, PROMPTS, MAX_NEW)
    _assert_same_run(got, reference(("edge", "quickstart", 1)))


def test_run_hybrid_and_edgefm_identical(weights, reference):
    """The two remaining baselines: confidence-only offload (a fresh
    device runtime built inside run_hybrid) and input-level offload by
    prompt perplexity."""
    ref_dev = RefDevice(weights["slm"], weights["slm_p"], gamma=4, s_max=256,
                        policy=RefPolicy(**POLICIES["quickstart"]))
    dev, eng = _port(weights, "pallas")
    _assert_same_run(SY.run_hybrid(dev, eng, PROMPTS, MAX_NEW),
                     RSY.run_hybrid(ref_dev, reference.engine, PROMPTS,
                                    MAX_NEW))
    ref_dev.rng = np.random.default_rng(ref_dev.seed)
    dev, eng = _port(weights, "pallas")
    for p in PROMPTS:
        assert dev.perplexity(p) == pytest.approx(ref_dev.perplexity(p),
                                                  rel=1e-5)
    _assert_same_run(SY.run_edgefm(dev, eng, PROMPTS, MAX_NEW),
                     RSY.run_edgefm(ref_dev, reference.engine, PROMPTS,
                                    MAX_NEW))


def test_engine_rows_match(weights, reference):
    """feed / prefill / decode rows of one engine step sequence equal the
    reference engine's (its cache starts from a fresh engine)."""
    ref = RefEngine(weights["llm"], weights["llm_p"], max_slots=2, s_max=64)
    _, port = _port(weights, "pallas")
    port = CloudEngine(port.cfg, weights["t_llm_p"], max_slots=2, s_max=64,
                       device="cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(1, 64, (2, 12)).astype(np.int32)
    pos = np.stack([np.arange(12), np.r_[np.arange(9), [-1] * 3]]).astype(
        np.int32)
    np.testing.assert_allclose(port.prefill(toks, pos),
                               ref.prefill(toks, pos), atol=2e-5, rtol=2e-5)
    ftok = rng.integers(1, 64, (2, 6)).astype(np.int32)
    fpos = np.stack([12 + np.arange(6), np.r_[9 + np.arange(4), -1, -1]]
                    ).astype(np.int32)
    targets = rng.integers(-1, 64, (2, 6)).astype(np.int32)
    sel = np.full((2, 8), -1, np.int32)
    sel[0, :5], sel[1, :3] = np.arange(1, 6), np.arange(3)
    for need in (True, False):
        got = port.feed(ftok, fpos, targets, sel, need_dists=need)
        want = ref.feed(ftok, fpos, targets, sel, need_dists=need)
        np.testing.assert_array_equal(got.token_id, want.token_id)
        np.testing.assert_allclose(got.p_draft, want.p_draft, atol=1e-6)
        np.testing.assert_allclose(np.sort(got.topk_val, -1),
                                   np.sort(want.topk_val, -1), atol=1e-6)
    dtok = np.array([[5], [7]], np.int32)
    dpos = np.array([[18], [-1]], np.int32)       # slot 1 idle
    got, want = port.decode(dtok, dpos), ref.decode(dtok, dpos)
    assert got.token_id[0] == want.token_id[0]
    np.testing.assert_allclose(got.topk_val[0], want.topk_val[0], atol=1e-6)
    assert port.pool_stats == ref.pool_stats
    assert port.compile_stats["calls"] == ref.compile_stats["calls"]
    assert port.compile_stats["buckets"] == ref.compile_stats["buckets"]
    port.reset_slot(0)
    assert (port.cache["layers"]["pos"][:, 0] == -1).all()
