"""Port ``ReplicaRouter`` against the reference's on the two scenarios of
``tests/test_router.py`` whose counters depend on pool state: prefix
affinity over retained prefixes, and a replica killed mid-verify.

Both packages run one script on two retaining paged replicas (the
module's two reference engines, and a port mirror pair): two waves that
share a 32-token system prompt under ``prefix-affinity``, the waves'
single-engine oracle, then a fleet whose replica 0 is killed while it
holds a session in ``WAIT_CLOUD``.  Each step's placements, streams and
stats dicts are recorded, and the tests hold the port's record against
the reference's, key for key.
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
from repro.serving.router import ReplicaRouter as RefRouter
from repro.serving.server import WAIT_CLOUD as REF_WAIT_CLOUD
from repro.serving.server import build_fleet as ref_build_fleet
from repro_torch import bridge
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.core.offload import OffloadPolicy
from repro_torch.serving import synergy as SY
from repro_torch.serving.device import DeviceRuntime
from repro_torch.serving.engine import CloudEngine
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.server import WAIT_CLOUD, build_fleet
from test_torch_fleet import assert_same_values, ref_kv_cache_bytes

MAX_NEW = 8
ENGINE_KW = dict(max_slots=2, s_max=256, cache_impl="paged", block_size=16,
                 share_prefix=True, retain_prefix=True)
DEVICE_KW = dict(s_max=256, gamma=4, seed=0, use_early_exit=False,
                 use_pi=False)


def _waves():
    rng = np.random.default_rng(23)
    common = [int(t) for t in rng.integers(1, 60, 32)]
    wave1 = [common + [int(t) for t in rng.integers(1, 60, 8)]
             for _ in range(2)]
    wave2 = [common + [int(t) for t in rng.integers(1, 60, 8)]
             for _ in range(2)]
    return wave1, wave2


def _kill_prompts():
    rng = np.random.default_rng(11)
    return [[int(t) for t in rng.integers(1, 60, 12)] for _ in range(4)]


def _script(dev, engines, *, build, router_cls, run_synera, wait_cloud):
    """The scenario, written once for either package."""
    rec = {}
    wave1, wave2 = _waves()
    router = router_cls(build(dev, engines), policy="prefix-affinity")
    m1 = router.serve(wave1, MAX_NEW, concurrency=1)
    rec["owners1"] = [router.owner[id(s)] for s in router.sessions]
    rec["stats_w1"] = router.stats()
    m2 = router.serve(wave2, MAX_NEW, concurrency=2)
    rec["owners2"] = [router.owner[id(s)]
                      for s in router.sessions[len(wave1):]]
    rec["stats"] = router.stats()
    rec["replicas"] = [router.replica_stats(i) for i in range(2)]
    rec["waves"] = [[int(t) for t in m.tokens] for m in m1 + m2]
    rec["oracle_waves"] = [
        [int(t) for t in o]
        for wave in (wave1, wave2)
        for o in run_synera(dev, engines[0], wave, MAX_NEW,
                            concurrency=1).outputs]

    prompts = _kill_prompts()
    rec["oracle_kill"] = [[int(t) for t in o] for o in run_synera(
        dev, engines[1], prompts, MAX_NEW, concurrency=1).outputs]
    router = router_cls(build(dev, engines), policy="round-robin")
    sess = [router.open_session(p, MAX_NEW) for p in prompts]
    for step in range(400):
        router.step()
        if any(s.state == wait_cloud
               for s in router.replicas[0].sessions if not s.done):
            break
    rec["kill_step"] = step
    rec["moved"] = router.kill_replica(0)
    rec["moved_again"] = router.kill_replica(0)
    while router.step():
        pass
    rec["kill_streams"] = [[int(t) for t in s.metrics.tokens] for s in sess]
    rec["kill_stats"] = router.stats()
    rec["kill_replicas"] = [router.replica_stats(i) for i in range(2)]
    return rec


@pytest.fixture(scope="module")
def records():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    slm, llm = tiny_pair(vocab=64)
    slm_p = JM.init_params(slm, jax.random.PRNGKey(0))
    llm_p = JM.init_params(llm, jax.random.PRNGKey(1))
    ref = _script(RefDevice(slm, slm_p, policy=RefPolicy(mode="all"),
                            **DEVICE_KW),
                  [RefEngine(llm, llm_p, **ENGINE_KW) for _ in range(2)],
                  build=ref_build_fleet, router_cls=RefRouter,
                  run_synera=RSY.run_synera, wait_cloud=REF_WAIT_CLOUD)
    pslm, pllm = port_tiny_pair(vocab=64)
    t_slm_p = bridge.params_from_reference(jax.tree.map(np.asarray, slm_p),
                                           device="cpu")
    t_llm_p = bridge.params_from_reference(jax.tree.map(np.asarray, llm_p),
                                           device="cpu")
    engines = [CloudEngine(pllm, t_llm_p, device="cpu", **ENGINE_KW)
               for _ in range(2)]
    port = _script(DeviceRuntime(pslm, t_slm_p, device="cpu",
                                 policy=OffloadPolicy(mode="all"),
                                 **DEVICE_KW),
                   engines, build=build_fleet, router_cls=ReplicaRouter,
                   run_synera=SY.run_synera, wait_cloud=WAIT_CLOUD)
    port["engines"] = engines
    torch.set_num_threads(n)
    return ref, port


def _same_stats(got, want, engines):
    got = dict(got, kv_cache_bytes=sum(ref_kv_cache_bytes(e)
                                       for e in engines))
    assert_same_values(got, want)


def test_prefix_affinity_lands_on_cached_replica(records):
    ref, port = records
    assert port["owners1"] == ref["owners1"] == [0, 0]
    assert port["owners2"] == ref["owners2"] == [0, 0]
    stats = port["stats"]
    assert stats["affinity_hits"] >= 3
    assert stats["revived_blocks"] > 0
    assert (stats["revived_blocks"] + stats["dedupe_hit_blocks"]
            > port["stats_w1"]["revived_blocks"]
            + port["stats_w1"]["dedupe_hit_blocks"])
    assert port["waves"] == port["oracle_waves"] == ref["oracle_waves"]
    engines = port["engines"]
    _same_stats(port["stats_w1"], ref["stats_w1"], engines)
    _same_stats(stats, ref["stats"], engines)
    for i in range(2):
        _same_stats(port["replicas"][i], ref["replicas"][i], [engines[i]])


def test_replica_kill_mid_verify(records):
    ref, port = records
    assert port["kill_step"] == ref["kill_step"] < 399
    assert port["moved"] == ref["moved"] >= 1
    assert port["moved_again"] == 0
    assert port["kill_streams"] == port["oracle_kill"] == ref["oracle_kill"]
    stats = port["kill_stats"]
    assert stats["rerouted_sessions"] == port["moved"]
    assert stats["dead_replicas"] == 1 and stats["completed_streams"] == 4
    assert port["kill_replicas"][0]["dead"]
    assert not port["kill_replicas"][1]["dead"]
    engines = port["engines"]
    assert engines[0].dead
    with pytest.raises(RuntimeError, match="marked dead"):
        engines[0].feed(np.zeros((2, 4), np.int32),
                        np.full((2, 4), -1, np.int32))
    _same_stats(stats, ref["kill_stats"], engines)
    for i in range(2):
        _same_stats(port["kill_replicas"][i], ref["kill_replicas"][i],
                    [engines[i]])
