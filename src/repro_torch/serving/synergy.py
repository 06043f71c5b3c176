"""End-to-end device-cloud orchestration (Fig 8) and the paper's four
baselines (§6.1): Edge-centric, Cloud-centric, Hybrid [9], EdgeFM-LLM
(port of ``repro/serving/synergy.py``; ``run_synera_fleet`` serves
across replicas behind ``serving/router.py``).

``CloudClient`` is one device stream's handle on the cloud runtime.  It
exposes non-blocking submission (``prefill_async`` / ``verify_async``)
used by the multi-tenant ``SyneraServer`` event loop
(serving/server.py), plus the legacy blocking facade (``prefill`` /
``verify``) that spins the scheduler until its own request completes —
kept for single-stream baselines such as the cloud-centric decode loop.

``run_synera`` and friends are thin wrappers over the server: with the
default ``concurrency=1`` they reproduce the original strictly
sequential semantics (identical token streams and per-stream
timelines); with ``concurrency=N`` the scheduler genuinely packs verify
chunks from multiple streams per iteration.  Token streams are real
model outputs; only wall-clock is modeled (see serving/link.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.verifier import VerifyResult
from repro_torch.serving.device import DeviceMetrics, DeviceRuntime
from repro_torch.serving.engine import CloudEngine
from repro_torch.serving.link import CloudLatencyModel, CostModel, LinkModel
from repro_torch.serving.scheduler import (PrefillRequest,
                                           VerificationAwareScheduler,
                                           VerifyRequest)


class CloudClient:
    """One device stream's view of the cloud runtime."""

    def __init__(self, scheduler: VerificationAwareScheduler,
                 sampling: str = "greedy", slo=None):
        self.sched = scheduler
        self.sampling = sampling
        self.slo = slo              # StreamSLO for slo-aware preemption
        self.slot = None
        self.last_fed_tokens = 0
        self.total_fed_tokens = 0   # generation-phase feeds only
        self.prefill_tokens = 0

    # -- non-blocking submission (SyneraServer event loop) -------------
    def prefill_async(self, prompt: list[int], arrival_ms: float = 0.0) -> int:
        """Queue the prompt prefill; returns the request id.  The slot is
        assigned when the scheduler emits ``prefill_done`` (see
        ``on_event``)."""
        rid = self.sched.next_req_id()
        self.sched.submit_prefill(PrefillRequest(
            rid, np.asarray(prompt), arrival_ms=arrival_ms, slo=self.slo))
        # prompt prefill tracked separately from generation-phase feeds
        self.prefill_tokens = len(prompt)
        return rid

    def verify_async(self, seq: list[int], draft: list[int], dists,
                     arrival_ms: float = 0.0) -> int:
        """Queue a verification request; returns the request id.

        ``seq`` is the device's accepted stream (prompt + output).
        Tokens beyond the cloud's cached frontier are the uncached
        device-accepted tokens of the partial prefill (§3.4)."""
        uncached = np.asarray(seq[self.frontier():], np.int64)
        self.last_fed_tokens = len(uncached) + len(draft)
        self.total_fed_tokens += self.last_fed_tokens
        rid = self.sched.next_req_id()
        # the full accepted stream rides along so a paged-pool preemption
        # can restart the request as a from-scratch partial prefill
        self.sched.submit_verify(VerifyRequest(
            rid, self.slot, uncached=uncached,
            draft=np.asarray(draft, np.int64),
            q_sparse=[(d.idx, d.val) for d in dists],
            sampling=self.sampling, arrival_ms=arrival_ms,
            seq=np.asarray(seq, np.int64)))
        return rid

    def on_event(self, ev) -> None:
        """Apply a scheduler completion event for one of our requests."""
        if ev.kind == "prefill_done":
            self.slot = ev.slot

    def frontier(self) -> int:
        return int(self.sched.cloud_len[self.slot])

    def release(self):
        if self.slot is not None:
            self.sched.release_slot(self.slot)
            self.slot = None

    # -- legacy blocking facade ----------------------------------------
    def _run_until(self, req_id: int, kind: str):
        while True:
            t_before = self.sched.sim_ms
            evs = self.sched.run_iteration()
            for ev in evs:
                if ev.req_id == req_id and ev.kind == kind:
                    return ev
            if not self.sched.has_work():
                raise RuntimeError("scheduler idle before completion")
            if not evs and self.sched.sim_ms == t_before:
                # nothing executed, nothing to fast-forward to: only an
                # external action (slot release) could unblock — a bare
                # blocking client has none coming, so fail loudly
                raise RuntimeError(
                    "blocking CloudClient stalled (request blocked with "
                    "no slot free and no other work); use SyneraServer "
                    "for oversubscribed multi-stream serving")

    def prefill(self, prompt: list[int], arrival_ms: float = 0.0):
        rid = self.prefill_async(prompt, arrival_ms=arrival_ms)
        t0 = self.sched.sim_ms
        ev = self._run_until(rid, "prefill_done")
        self.on_event(ev)
        # elapsed from when the request could first be served: the clock
        # may fast-forward to arrival_ms if the scheduler was idle
        return self.sched.sim_ms - max(t0, arrival_ms)

    def verify(self, seq: list[int], draft: list[int], dists,
               arrival_ms: float = 0.0) -> tuple[VerifyResult, float]:
        rid = self.verify_async(seq, draft, dists, arrival_ms=arrival_ms)
        t0 = self.sched.sim_ms
        ev = self._run_until(rid, "verify_done")
        return ev.result, self.sched.sim_ms - max(t0, arrival_ms)


# ---------------------------------------------------------------------------
# End-to-end runs
# ---------------------------------------------------------------------------

@dataclass
class RunResult:
    outputs: list = field(default_factory=list)     # list[list[int]]
    metrics: list = field(default_factory=list)     # list[DeviceMetrics]
    tbt_ms: float = 0.0
    cloud_token_frac: float = 0.0
    cloud_fed_frac: float = 0.0
    cost: float = 0.0
    extras: dict = field(default_factory=dict)

    def summarize(self, cost_model: CostModel):
        tbts = [m.tbt_ms for m in self.metrics]
        self.tbt_ms = float(np.mean(tbts)) if tbts else 0.0
        fracs = [m.cloud_token_frac for m in self.metrics]
        self.cloud_token_frac = float(np.mean(fracs)) if fracs else 0.0
        fed = [m.n_cloud_fed_tokens / max(len(m.tokens), 1)
               for m in self.metrics]
        self.cloud_fed_frac = float(np.mean(fed)) if fed else 0.0
        # paper §6.1: c = (1/Pf) x T x W with W = fraction of tokens
        # whose generation involved the cloud (verified tokens); the
        # generation-phase fed-token count is kept as a diagnostic
        self.cost = cost_model.cost(self.tbt_ms, self.cloud_token_frac)
        return self


def run_synera(device: DeviceRuntime, engine: CloudEngine,
               prompts: list[list[int]], max_new: int, *,
               sampling: str = "greedy",
               cost_model: CostModel | None = None,
               profile_mode: bool = False,
               chunk: int = 32,
               concurrency: int | None = 1,
               arrivals: list[float] | None = None,
               latency: CloudLatencyModel | None = None,
               preempt_policy: str | None = None,
               slos: list | None = None,
               trace: bool = False) -> RunResult:
    """Serve ``prompts`` through the Synera pipeline.

    ``concurrency=1`` (default) runs streams strictly one after another
    (the original blocking semantics); ``concurrency=N`` (or ``None``
    for unbounded) lets the SyneraServer event loop interleave up to N
    device streams over the shared cloud engine, so verify iterations
    pack chunks from multiple slots.  ``arrivals`` optionally gives each
    stream an absolute arrival offset (ms) on the shared clock;
    ``preempt_policy`` / ``slos`` select the eviction victim policy and
    attach per-stream latency budgets (serving/swap.py).  ``trace=True``
    attaches a ``Tracer`` on the shared clock (``extras['tracer']``) —
    token streams are byte-identical either way.
    """
    from repro_torch.serving.link import SimClock
    from repro_torch.serving.server import SyneraServer
    from repro_torch.serving.trace import Tracer
    clock = SimClock()
    tracer = Tracer(clock) if trace else None
    server = SyneraServer(device, engine, chunk=chunk, sampling=sampling,
                          latency=latency, preempt_policy=preempt_policy,
                          clock=clock, tracer=tracer)
    metrics = server.serve(prompts, max_new, concurrency=concurrency,
                           arrivals=arrivals, profile_mode=profile_mode,
                           slos=slos)
    res = RunResult()
    for m in metrics:
        res.outputs.append(m.tokens)
        res.metrics.append(m)
    res.extras["scheduler"] = server.stats()
    if tracer is not None:
        res.extras["tracer"] = tracer
    return res.summarize(cost_model or CostModel())


def run_synera_fleet(device: DeviceRuntime, engines: list[CloudEngine],
                     prompts: list[list[int]], max_new: int, *,
                     policy: str = "least-loaded",
                     replica_queue_cap: int = 0,
                     sampling: str = "greedy",
                     cost_model: CostModel | None = None,
                     chunk: int = 32,
                     concurrency: int | None = 1,
                     arrivals: list[float] | None = None,
                     latency: CloudLatencyModel | None = None,
                     preempt_policy: str | None = None,
                     slos: list | None = None,
                     trace: bool = False) -> RunResult:
    """Serve ``prompts`` across a fleet of cloud replicas behind a
    ``ReplicaRouter`` (serving/router.py).

    One ``SyneraServer`` per engine, all on one shared clock and one
    device runtime; each admission is placed by ``policy`` (round-robin
    / least-loaded / prefix-affinity).  Placement must never change
    content: greedy token streams are byte-identical to the
    single-engine ``run_synera`` run regardless of policy or replica
    count.  ``replica_queue_cap`` bounds live sessions per replica —
    when every replica is past it, new streams degrade to device-only
    generation instead of being rejected.  ``extras['scheduler']`` is
    the fleet-aggregated stats dict; ``extras['replicas']`` the
    per-replica views."""
    from repro_torch.serving.link import SimClock
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.serving.server import build_fleet
    from repro_torch.serving.trace import Tracer
    clock = SimClock()
    tracer = Tracer(clock) if trace else None
    servers = build_fleet(device, engines, chunk=chunk, sampling=sampling,
                          latency=latency, preempt_policy=preempt_policy,
                          clock=clock, tracer=tracer)
    router = ReplicaRouter(servers, policy=policy,
                           replica_queue_cap=replica_queue_cap)
    metrics = router.serve(prompts, max_new, concurrency=concurrency,
                           arrivals=arrivals, slos=slos)
    res = RunResult()
    for m in metrics:
        res.outputs.append(m.tokens)
        res.metrics.append(m)
    res.extras["scheduler"] = router.stats()
    res.extras["replicas"] = [router.replica_stats(i)
                              for i in range(router.n_replicas)]
    if tracer is not None:
        res.extras["tracer"] = tracer
    return res.summarize(cost_model or CostModel())


def run_edge_centric(device: DeviceRuntime, prompts, max_new,
                     cost_model=None) -> RunResult:
    res = RunResult()
    for prompt in prompts:
        m = device.generate(prompt, max_new, cloud=None)
        res.outputs.append(m.tokens)
        res.metrics.append(m)
    return res.summarize(cost_model or CostModel())


def run_cloud_centric(engine: CloudEngine, prompts, max_new, *,
                      link: LinkModel | None = None,
                      latency: CloudLatencyModel | None = None,
                      cost_model=None, sampling: str = "greedy") -> RunResult:
    """All queries offloaded; the cloud decodes every token (continuous
    batching decode iterations).  TBT includes the per-token downlink."""
    link = link or LinkModel()
    res = RunResult()
    sched = VerificationAwareScheduler(engine,
                                       latency=latency or CloudLatencyModel())
    B = engine.max_slots
    for prompt in prompts:
        client = CloudClient(sched, sampling=sampling)
        t0 = sched.sim_ms
        client.prefill(prompt)
        slot = client.slot
        out = []
        last = int(np.argmax(sched.last_row[slot]))
        out.append(last)
        tokens = np.zeros((B, 1), np.int32)
        positions = np.full((B, 1), -1, np.int32)
        while len(out) < max_new:
            tokens[slot, 0] = last
            positions[slot, 0] = len(prompt) + len(out) - 1
            rows = sched.decode_iteration(tokens, positions)
            last = int(rows.token_id[slot])
            out.append(last)
        m = DeviceMetrics()
        m.tokens = out[:max_new]
        m.n_cloud_tokens = len(m.tokens)
        m.n_cloud_fed_tokens = len(out)
        # time: cloud iterations + per-token downlink
        cloud_ms = sched.sim_ms - t0
        comm_ms = (link.transfer_ms(4 * len(prompt) + 32)
                   + len(out) * link.transfer_ms(36))
        m.timeline.advance(cloud_ms, "compute")
        m.timeline.advance(comm_ms, "comm")
        res.outputs.append(m.tokens)
        res.metrics.append(m)
        client.release()
    return res.summarize(cost_model or CostModel())


def run_hybrid(device: DeviceRuntime, engine: CloudEngine, prompts, max_new,
               *, cost_model=None, chunk: int = 32,
               concurrency: int | None = 1,
               arrivals: list[float] | None = None,
               preempt_policy: str | None = None,
               trace: bool = False) -> RunResult:
    """Hybrid [9]: SLM-LLM token-level offloading by *confidence only*
    (no importance, no PI, no early exit)."""
    from repro_torch.core.offload import OffloadPolicy
    dev = DeviceRuntime(
        device.cfg, device.params, s_max=device.s_max, gamma=device.gamma,
        policy=OffloadPolicy(c_th=device.policy.c_th, mode="conf"),
        sampling=device.sampling, latency=device.latency, link=device.link,
        use_early_exit=False, use_pi=False, alpha=device.alpha,
        wire_vocab=device.wire_vocab, device=device.device)
    return run_synera(dev, engine, prompts, max_new, cost_model=cost_model,
                      chunk=chunk, concurrency=concurrency,
                      arrivals=arrivals, preempt_policy=preempt_policy,
                      trace=trace)


def run_edgefm(device: DeviceRuntime, engine: CloudEngine, prompts, max_new,
               *, ppl_threshold: float = 0.0, cost_model=None,
               link: LinkModel | None = None) -> RunResult:
    """EdgeFM [38] adapted to LLMs (§6.1): *input-level* offloading —
    high-perplexity prompts go entirely to the cloud, the rest stay
    entirely on the device."""
    ppls = [device.perplexity(p) for p in prompts]
    thr = ppl_threshold or float(np.median(ppls))
    res = RunResult()
    for prompt, ppl in zip(prompts, ppls):
        if ppl > thr:
            r = run_cloud_centric(engine, [prompt], max_new, link=link)
            res.outputs.append(r.outputs[0])
            res.metrics.append(r.metrics[0])
        else:
            m = device.generate(prompt, max_new, cloud=None)
            res.outputs.append(m.tokens)
            res.metrics.append(m)
    return res.summarize(cost_model or CostModel())
