"""Port fleet (``serving/router.py``, ``build_fleet``,
``aggregate_server_stats``, ``run_synera_fleet``) against the reference.

The invariant is the reference's own (``tests/test_router.py``):
placement never changes content, so every fleet stream equals the
single-engine ``run_synera`` oracle.  On top of it, each two-replica run
is held against the reference's ``run_synera_fleet`` on the same inputs:
the fleet view and every replica's view, key for key.

Two reference engines (paged, prefix sharing, no retention) are built
once for the module and reused, as ``tests/test_router.py`` reuses its
fleet.  Pool counters such as ``peak_used_blocks`` live as long as an
engine does, so the port's two-replica runs use a mirror pair of port
engines that receives exactly the same sequence of runs.  One-replica
and behaviour cases take fresh port engines, which cost nothing to build.
"""
import math

import numpy as np
import pytest

import jax
import torch

from repro.configs.synera_pair import tiny_pair
from repro.core.offload import OffloadPolicy as RefPolicy
from repro.models import model as JM
from repro.serving import server as RS
from repro.serving import synergy as RSY
from repro.serving.device import DeviceRuntime as RefDevice
from repro.serving.engine import CloudEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.core.offload import OffloadPolicy
from repro_torch.serving import server as PS
from repro_torch.serving import synergy as SY
from repro_torch.serving.device import DeviceRuntime
from repro_torch.serving.engine import CloudEngine
from repro_torch.serving.router import ROUTE_POLICIES, ReplicaRouter
from repro_torch.serving.server import WAIT_CLOUD, WAIT_SLOT, build_fleet

N, MAX_NEW = 4, 8
ENGINE_KW = dict(max_slots=2, s_max=256, cache_impl="paged", block_size=16,
                 share_prefix=True)
DEVICE_KW = dict(s_max=256, gamma=4, seed=0, use_early_exit=False,
                 use_pi=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    slm, llm = tiny_pair(vocab=64)
    slm_p = JM.init_params(slm, jax.random.PRNGKey(0))
    llm_p = JM.init_params(llm, jax.random.PRNGKey(1))
    pslm, pllm = port_tiny_pair(vocab=64)
    return dict(
        slm=slm, llm=llm, slm_p=slm_p, llm_p=llm_p, pslm=pslm, pllm=pllm,
        t_slm_p=bridge.params_from_reference(
            jax.tree.map(np.asarray, slm_p), device="cpu"),
        t_llm_p=bridge.params_from_reference(
            jax.tree.map(np.asarray, llm_p), device="cpu"))


def port_engine(pair, **kw):
    return CloudEngine(pair["pllm"], pair["t_llm_p"], device="cpu",
                       **{**ENGINE_KW, **kw})


def port_device(pair):
    return DeviceRuntime(pair["pslm"], pair["t_slm_p"], device="cpu",
                         policy=OffloadPolicy(mode="all"), **DEVICE_KW)


@pytest.fixture(scope="module")
def sides(pair):
    """The reference's device + two engines, and the port's mirror."""
    ref_dev = RefDevice(pair["slm"], pair["slm_p"],
                        policy=RefPolicy(mode="all"), **DEVICE_KW)
    ref_engines = [RefEngine(pair["llm"], pair["llm_p"], **ENGINE_KW)
                   for _ in range(2)]
    return dict(ref_dev=ref_dev, ref_engines=ref_engines,
                dev=port_device(pair),
                engines=[port_engine(pair) for _ in range(2)])


def prompts_for(n, length=8, shared=0, seed=5):
    """``tests/test_router.py``'s prompts: a 16-token common prefix on
    the first ``shared`` prompts."""
    rng = np.random.default_rng(seed)
    common = [int(t) for t in rng.integers(1, 60, 16)]
    return [(common if i < shared else [])
            + [int(t) for t in rng.integers(1, 60, length)]
            for i in range(n)]


def arrivals_for(kind, n):
    if kind == "none":
        return None
    if kind == "zero":
        return [0.0] * n
    rng = np.random.default_rng(2)
    return np.cumsum(rng.exponential(40.0, n)).tolist()


def tokens(outputs):
    return [[int(t) for t in o] for o in outputs]


_ORACLE: dict = {}


def oracle(sides, prompts):
    """The reference's single-engine run, once per prompt set.  The port
    mirror engine 0 serves the same run, so both pairs keep one history
    (and the port's single-engine streams are checked on the way)."""
    key = tuple(tuple(p) for p in prompts)
    if key not in _ORACLE:
        ref = RSY.run_synera(sides["ref_dev"], sides["ref_engines"][0],
                             prompts, MAX_NEW, concurrency=1)
        got = SY.run_synera(sides["dev"], sides["engines"][0], prompts,
                            MAX_NEW, concurrency=1)
        assert tokens(got.outputs) == tokens(ref.outputs)
        _ORACLE[key] = tokens(ref.outputs)
    return _ORACLE[key]


def ref_kv_cache_bytes(engine) -> int:
    """The reference's ``kv_cache_bytes`` for a port paged engine: it
    holds one block table per layer where the port holds one."""
    table = engine.cache["layers"]["block_tables"]
    return (engine.kv_cache_bytes()
            + (engine.cfg.n_layers - 1) * table.numel() * table.element_size())


def assert_same_values(got, want, path="stats"):
    """Equal key for key: counters, flags and strings exactly, floats to
    1e-9 relative, nested dicts and lists element by element."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same_values(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_values(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert math.isclose(got, want, rel_tol=1e-9, abs_tol=0.0) or (
            got == want), (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def assert_pristine(eng):
    pool = eng.pool_stats
    assert pool["used_blocks"] == 0, pool
    assert (pool["free_blocks"] + pool["cached_free_blocks"]
            == pool["n_blocks"]), pool


# ---------------------------------------------------------------------------
# Identity grid: policies x replica counts x arrivals x shared-prefix fraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", ["none", "all"])
@pytest.mark.parametrize("arrival", ["none", "zero", "poisson"])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("policy", ROUTE_POLICIES)
def test_fleet_streams_match_reference(pair, sides, policy, n_rep, arrival,
                                       frac):
    prompts = prompts_for(N, shared=N if frac == "all" else 0)
    arrivals = arrivals_for(arrival, N)
    want = oracle(sides, prompts)
    engines = (sides["engines"] if n_rep == 2 else [port_engine(pair)])
    got = SY.run_synera_fleet(sides["dev"], engines, prompts, MAX_NEW,
                              policy=policy, concurrency=N,
                              arrivals=arrivals)
    assert tokens(got.outputs) == want
    stats = got.extras["scheduler"]
    assert stats["replicas"] == n_rep and stats["route_policy"] == policy
    assert stats["completed_streams"] == N
    assert stats["degraded_streams"] == 0
    for eng in engines:
        assert_pristine(eng)
    if n_rep == 1:
        return
    ref = RSY.run_synera_fleet(sides["ref_dev"], sides["ref_engines"],
                               prompts, MAX_NEW, policy=policy,
                               concurrency=N, arrivals=arrivals)
    assert tokens(ref.outputs) == want
    views = [(got.extras["scheduler"], ref.extras["scheduler"], engines)]
    views += [(g, r, [e]) for g, r, e in zip(got.extras["replicas"],
                                             ref.extras["replicas"], engines)]
    for g, r, engs in views:
        g = dict(g, kv_cache_bytes=sum(ref_kv_cache_bytes(e) for e in engs))
        assert_same_values(g, r)
    for m, rm in zip(got.metrics, ref.metrics):
        assert m.timeline.t_ms == pytest.approx(rm.timeline.t_ms, rel=1e-9)


# ---------------------------------------------------------------------------
# Behaviour cases (tests/test_router.py)
# ---------------------------------------------------------------------------

def test_round_robin_rotates(pair):
    dev = port_device(pair)
    router = ReplicaRouter(build_fleet(dev, [port_engine(pair),
                                             port_engine(pair)]),
                           policy="round-robin")
    router.serve(prompts_for(4), 4, concurrency=4)
    assert [router.owner[id(s)] for s in router.sessions] == [0, 1, 0, 1]


def test_kill_before_first_step_reroutes_fresh_sessions(pair, sides):
    """Sessions that never reached the cloud re-run as fresh sessions on
    the survivor and match the reference's single-engine run."""
    prompts = prompts_for(2, seed=13)
    engines = [port_engine(pair), port_engine(pair)]
    router = ReplicaRouter(build_fleet(port_device(pair), engines),
                           policy="round-robin")
    sess = [router.open_session(p, MAX_NEW) for p in prompts]
    assert router.kill_replica(0) == 1
    while router.step():
        pass
    assert all(s.done and s.metrics is not None for s in sess)
    assert_pristine(engines[1])
    assert tokens([s.metrics.tokens for s in sess]) == oracle(sides, prompts)
    stats = router.stats()
    assert stats["rerouted_sessions"] == 1 and stats["dead_replicas"] == 1
    assert stats["completed_streams"] == 2


def test_saturation_degrades_to_device(pair, sides):
    """Every replica past its queue cap: the stream completes on the
    device alone (no cloud tokens) instead of being refused."""
    prompts = prompts_for(3, seed=17)
    router = ReplicaRouter(build_fleet(port_device(pair), [port_engine(pair)]),
                           policy="least-loaded", replica_queue_cap=2)
    s1 = router.open_session(prompts[0], MAX_NEW)
    s2 = router.open_session(prompts[1], MAX_NEW)
    s3 = router.open_session(prompts[2], MAX_NEW)
    assert s3.done and len(s3.metrics.tokens) == MAX_NEW
    assert s3.metrics.n_cloud_tokens == 0
    assert s3.metrics.n_cloud_fed_tokens == 0
    assert router.owner[id(s3)] == -1 and router.degraded_streams == 1
    while router.step():
        pass
    assert tokens([s1.metrics.tokens, s2.metrics.tokens]) == \
        oracle(sides, prompts[:2])
    stats = router.stats()
    assert stats["degraded_streams"] == 1 and stats["completed_streams"] == 3
    s4 = router.open_session(prompts[0], MAX_NEW)
    assert router.owner[id(s4)] == 0
    while router.step():
        pass
    assert tokens([s4.metrics.tokens]) == tokens([s1.metrics.tokens])
    # the reference's device-only stream for the same prompt
    ref = RSY.run_edge_centric(sides["ref_dev"], [prompts[2]], MAX_NEW)
    assert tokens([s3.metrics.tokens]) == tokens(ref.outputs)


@pytest.mark.parametrize("state", [WAIT_CLOUD, WAIT_SLOT])
def test_export_import_round_trip(pair, sides, state):
    """A session exported from one server and imported on another in the
    middle of its run (parked on a verify, or waiting for its prefill)
    finishes with the oracle's stream; the exporter keeps nothing."""
    prompts = prompts_for(2, length=12, seed=11)
    dev = port_device(pair)
    src, dst = build_fleet(dev, [port_engine(pair), port_engine(pair)])
    sess = [src.open_session(p, MAX_NEW) for p in prompts]
    for _ in range(400):
        if any(s.state == state for s in sess):
            break
        src.step()
    else:
        pytest.fail(f"no session reached {state}")
    moved = [(s, p) for s, p in zip(sess, prompts) if not s.done]
    for s, prompt in moved:
        parked = s.state in (WAIT_CLOUD, WAIT_SLOT)
        pending = src.export_session(s)
        assert (pending is not None) == parked
        if parked:
            assert pending.kind == "verify"
            assert pending.seq[:len(prompt)] == prompt
        dst.import_session(s, pending)
    assert src.sessions == [s for s in sess if s.done] == []
    assert not src._by_req
    while dst.step():
        pass
    assert tokens([s.metrics.tokens for s in sess]) == oracle(sides, prompts)
    assert_pristine(dst.engine)


# ---------------------------------------------------------------------------
# aggregate_server_stats on hand-built ServerStats
# ---------------------------------------------------------------------------

def _hand_stats(cls, seed):
    rng = np.random.default_rng(seed)
    d = {}
    for k, v in cls().as_dict().items():
        if isinstance(v, bool):
            d[k] = bool(rng.integers(0, 2))
        elif isinstance(v, int):
            d[k] = int(rng.integers(0, 50))
        elif isinstance(v, float):
            d[k] = float(rng.uniform(0, 100))
        elif isinstance(v, str):
            d[k] = f"{k}-{seed}"
        elif isinstance(v, dict):       # latency histograms
            h = RS.hist_from(rng.uniform(0, 5000, int(rng.integers(1, 9))))
            d[k] = h
    d["cache_impl"] = ("dense", "paged")[seed % 2]
    return d


@pytest.mark.parametrize("n_rep", [1, 2, 3])
def test_aggregate_server_stats_matches_reference(n_rep):
    dicts = [_hand_stats(RS.ServerStats, seed) for seed in range(n_rep)]
    ttfts, e2es = [3.0, 1.5, 9.25], [40.0, 12.5]
    want = RS.aggregate_server_stats(
        [RS.ServerStats(**d) for d in dicts], ttfts=ttfts, e2es=e2es)
    got = PS.aggregate_server_stats(
        [PS.ServerStats(**d) for d in dicts], ttfts=ttfts, e2es=e2es)
    assert_same_values(got.as_dict(), want.as_dict())
