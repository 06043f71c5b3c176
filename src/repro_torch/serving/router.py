"""Multi-replica cloud fleet: ``ReplicaRouter`` (port of
``repro/serving/router.py``).

Synera's offloading decision is point-to-point in the base system — one
device talks to one cloud engine.  At fleet scale the offload *target*
is itself a choice: each replica is an independent ``CloudEngine`` +
scheduler with its own block pool, prefix index and swap tier, so where
a request lands determines whether its system prompt is a cache hit or
a full refeed.  The router fronts N ``SyneraServer`` replicas (built by
``server.build_fleet`` on one shared clock and one ``DeviceRuntime``)
and places each incoming session by a pluggable policy:

``round-robin``
    Rotate over alive replicas.  The identity oracle: placement is
    oblivious to all state, so any output divergence under it is a
    correctness bug, not a routing artifact.

``least-loaded``
    Fewest live sessions, then most allocatable blocks, then fewest
    sessions ever served (so an idle fleet still spreads), then index.

``prefix-affinity``
    Probe each replica's chain-hash prefix index — device blocks via
    ``BlockAllocator.match_prefix``, then the content-addressed host
    tier via ``HostSwapManager.host_match_chain`` — and route to the
    replica already holding the longest prefix of the prompt; ties and
    cold prompts fall back to least-loaded.  This is how routing and
    the persistent prefix cache compose: a recurring system prompt
    concentrates on the replica that already has it.

Two degradation paths keep the fleet serving under stress:

* **Saturation**: when every alive replica is past its queue cap, the
  router degrades the stream to *device-only* generation — the SLM
  finishes solo (``generate_steps(use_cloud=False)`` never yields a
  cloud call, so the session completes synchronously at open) — instead
  of 429ing.  This is the Synera offloading decision generalized to a
  fleet: "nowhere worth offloading to" is just another reason not to
  offload.

* **Replica death**: ``kill_replica`` marks a replica dead (poisoning
  its engine), exports every live session and re-places each on a
  survivor as a from-scratch prefill of its accepted stream with the
  parked verify re-run on top — the recompute-eviction restart contract
  (``VerifyRequest.seq``).  Nothing on the dead replica is released:
  its pool dies with it.

Token identity is the invariant throughout: greedy token streams are
deterministic functions of tokens and positions only, and none of
placement, packing, re-placement or degradation changes either — every
stream is byte-identical to the single-engine run (tests/test_router).
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.server import (DONE, DeviceSession, ServerStats,
                                        SyneraServer,
                                        aggregate_server_stats)
from repro_torch.serving.trace import hist_add

ROUTE_POLICIES = ("round-robin", "least-loaded", "prefix-affinity")


class ReplicaRouter:
    """Places device sessions across N ``SyneraServer`` replicas."""

    def __init__(self, replicas: list[SyneraServer], *,
                 policy: str = "least-loaded",
                 replica_queue_cap: int = 0):
        if policy not in ROUTE_POLICIES:
            raise ValueError(f"unknown route policy {policy!r}; "
                             f"expected one of {ROUTE_POLICIES}")
        if not replicas:
            raise ValueError("need at least one replica")
        if len({id(s.clock) for s in replicas}) != 1:
            raise ValueError("replicas must share one clock "
                             "(use server.build_fleet)")
        if len({id(s.device) for s in replicas}) != 1:
            raise ValueError("replicas must share one DeviceRuntime")
        self.replicas = list(replicas)
        self.device = replicas[0].device
        self.clock = replicas[0].clock
        # one tracer serves the fleet (build_fleet hands the same
        # instance to every replica); router-level events — degrades,
        # reroutes, replica kills — stamp through it
        self.tracer = replicas[0].tracer
        self.policy = policy
        # live sessions a replica may hold before it counts as saturated
        # (0 = unbounded; saturation of ALL replicas => degrade-to-device)
        self.replica_queue_cap = replica_queue_cap
        self.dead = [False] * len(replicas)
        self.sessions: list[DeviceSession] = []   # fleet-wide, open order
        self.owner: dict[int, int] = {}           # id(session) -> replica (-1 = degraded)
        self._rr = 0
        # fleet telemetry (ServerStats fleet fields)
        self.degraded_streams = 0
        self.rerouted_sessions = 0
        self.affinity_hits = 0
        # gateway front-door attributes (same duck type as SyneraServer)
        self.ext_queue_depth = 0
        self.rejected_requests = 0

    # -- placement ------------------------------------------------------
    def _alive(self) -> list[int]:
        return [i for i in range(len(self.replicas)) if not self.dead[i]]

    def _live_load(self, i: int) -> int:
        srv = self.replicas[i]
        return len(srv.sessions) - srv._done_count

    def _has_capacity(self, i: int) -> bool:
        cap = self.replica_queue_cap
        return cap <= 0 or self._live_load(i) < cap

    def _allocatable(self, i: int) -> int:
        a = getattr(self.replicas[i].engine, "allocator", None)
        return a.allocatable_blocks() if a is not None else 0

    def _least_loaded(self, cands: list[int]) -> int:
        # most allocatable blocks breaks live-load ties; fewest sessions
        # ever served breaks full ties so an idle fleet still spreads
        return min(cands, key=lambda i: (self._live_load(i),
                                         -self._allocatable(i),
                                         len(self.replicas[i].sessions), i))

    def _affinity_tokens(self, i: int, prompt) -> int:
        """Tokens of ``prompt`` replica ``i`` already holds: leading full
        blocks in its device prefix index, then the chain continued in
        its content-addressed host store."""
        eng = self.replicas[i].engine
        alloc = getattr(eng, "allocator", None)
        if alloc is None or not alloc.share_prefix:
            return 0
        toks = np.asarray([int(t) for t in prompt], np.int64)
        n_blocks = len(alloc.match_prefix(toks))
        swap = getattr(eng, "swap_manager", None)
        if swap is not None and getattr(swap, "content_addressed", False):
            n_blocks += len(swap.host_match_chain(toks, n_blocks))
        return n_blocks * alloc.block_size

    def place(self, prompt) -> int | None:
        """Pick a replica index for a new session; None when every alive
        replica is saturated past its queue cap (degrade-to-device)."""
        cands = [i for i in self._alive() if self._has_capacity(i)]
        if not cands:
            return None
        if self.policy == "round-robin":
            n = len(self.replicas)
            for k in range(n):
                i = (self._rr + k) % n
                if i in cands:
                    self._rr = i + 1
                    return i
            return None                      # unreachable: cands nonempty
        if self.policy == "prefix-affinity":
            scored = [(self._affinity_tokens(i, prompt), i) for i in cands]
            best = max(m for m, _ in scored)
            if best > 0:
                self.affinity_hits += 1
                return self._least_loaded([i for m, i in scored if m == best])
        return self._least_loaded(cands)

    # -- session lifecycle ---------------------------------------------
    def open_session(self, prompt, max_new: int, *,
                     arrival_ms: float | None = None,
                     profile_mode: bool = False,
                     slo: object = None,
                     emit=None) -> DeviceSession:
        """Route and open one device stream (SyneraServer.open_session
        signature).  A saturated fleet degrades the stream to
        device-only generation — it completes before this returns."""
        ridx = self.place(prompt)
        if ridx is None:
            s = self._degrade(prompt, max_new, arrival_ms=arrival_ms,
                              profile_mode=profile_mode, emit=emit)
        else:
            s = self.replicas[ridx].open_session(
                prompt, max_new, arrival_ms=arrival_ms,
                profile_mode=profile_mode, slo=slo, emit=emit)
            self.owner[id(s)] = ridx
        self.sessions.append(s)
        return s

    def _degrade(self, prompt, max_new: int, *,
                 arrival_ms: float | None = None,
                 profile_mode: bool = False, emit=None) -> DeviceSession:
        """Device-only completion: with ``use_cloud=False`` the
        generation coroutine never yields a cloud call, so one resume
        drives it to StopIteration — the stream finishes solo on the
        SLM, off the shared clock's critical path."""
        self.degraded_streams += 1
        start = self.clock.now_ms if arrival_ms is None else arrival_ms
        s = DeviceSession(sid=-1, gen=None, client=None, start_ms=start)
        if self.tracer.enabled:
            self.tracer.instant("degrade", start)
            s.trace_uid = self.tracer.stream_begin(
                "stream", start,
                meta={"degraded": True, "prompt_tokens": len(prompt),
                      "max_new": max_new})

        def _emit(tokens, t_ms, _s=s, _user=emit):
            if _s.ttft_ms is None:
                _s.ttft_ms = t_ms
            _s.n_emitted += len(tokens)
            if _user is not None:
                _user(tokens, t_ms)

        gen = self.device.generate_steps(prompt, max_new, use_cloud=False,
                                         profile_mode=profile_mode,
                                         emit=_emit)
        s.gen = gen
        try:
            call = gen.send(None)
            raise RuntimeError(
                f"device-only generation yielded a cloud call ({call.kind})")
        except StopIteration as e:
            s.metrics = e.value
            s.e2e_ms = e.value.timeline.t_ms
            s.state = DONE
            if self.tracer.enabled and s.trace_uid >= 0:
                tl = e.value.timeline
                self.tracer.stream_end(
                    s.trace_uid, start + tl.t_ms,
                    meta={"wall_ms": tl.t_ms,
                          "tokens": len(e.value.tokens),
                          "buckets": tl.buckets()})
        self.owner[id(s)] = -1
        return s

    def cancel(self, session: DeviceSession) -> bool:
        """Tear down a mid-flight stream on whichever replica owns it.
        Degraded sessions completed at open, so there is nothing to
        cancel (returns False, like any done session)."""
        ridx = self.owner.get(id(session))
        if ridx is None or ridx < 0:
            return False
        return self.replicas[ridx].cancel(session)

    # -- fault injection ------------------------------------------------
    def kill_replica(self, idx: int) -> int:
        """Mark replica ``idx`` dead and re-place its live sessions on
        survivors.  Returns the number of sessions moved.

        The dead engine is poisoned first (``mark_dead``) so any stray
        dispatch fails loudly; each live session is then exported —
        its parked verify carries the full accepted stream — and
        imported on a survivor chosen by the routing policy (probing
        with the accepted stream under prefix-affinity; queue caps are
        ignored, survivors must absorb the failover).  Completed
        sessions keep their metrics and stay where they are."""
        if self.dead[idx]:
            return 0
        self.dead[idx] = True
        srv = self.replicas[idx]
        if hasattr(srv.engine, "mark_dead"):
            srv.engine.mark_dead()
        if self.tracer.enabled:
            self.tracer.instant("replica_kill", replica=idx)
        moved = 0
        for s in [x for x in srv.sessions if not x.done]:
            pending = srv.export_session(s)
            probe = pending.seq if pending is not None else None
            target = self._place_failover(probe)
            self.replicas[target].import_session(s, pending)
            self.owner[id(s)] = target
            if self.tracer.enabled and s.trace_uid >= 0:
                self.tracer.stream_instant(s.trace_uid, "reroute",
                                           self.clock.now_ms, n=target)
            moved += 1
        self.rerouted_sessions += moved
        return moved

    def _place_failover(self, probe) -> int:
        alive = self._alive()
        if not alive:
            raise RuntimeError("no surviving replica to re-place sessions on")
        if self.policy == "prefix-affinity" and probe is not None:
            scored = [(self._affinity_tokens(i, probe), i) for i in alive]
            best = max(m for m, _ in scored)
            if best > 0:
                return self._least_loaded([i for m, i in scored if m == best])
        return self._least_loaded(alive)

    # -- event loop -----------------------------------------------------
    def step(self) -> bool:
        """One fleet step: step every alive replica that has runnable
        work.  Returns False once every session fleet-wide is done.
        The shared clock makes per-replica fast-forwards safe: it never
        rewinds, and a request whose arrival is already in the past
        executes immediately."""
        live = False
        for i, srv in enumerate(self.replicas):
            if self.dead[i]:
                continue
            if srv._fresh or srv._done_count < len(srv.sessions):
                srv.step()
                live = live or srv._done_count < len(srv.sessions)
        return live

    def run(self) -> list:
        """Drive all open sessions to completion; metrics in open order."""
        while self.step():
            pass
        return [s.metrics for s in self.sessions]

    def serve(self, prompts, max_new: int, *,
              concurrency: int | None = None,
              arrivals: list[float] | None = None,
              profile_mode: bool = False,
              slos: list | None = None) -> list:
        """Admission-controlled loop (SyneraServer.serve signature),
        routing each admission through :meth:`place`.  Returns
        per-stream DeviceMetrics in prompt order."""
        if concurrency is not None and concurrency < 1:
            raise ValueError(f"concurrency must be >= 1 or None "
                             f"(unbounded), got {concurrency}")
        first = len(self.sessions)
        idx = 0
        active: list[DeviceSession] = []
        while idx < len(prompts) or active:
            while idx < len(prompts) and (concurrency is None
                                          or len(active) < concurrency):
                arr = None if arrivals is None else arrivals[idx]
                s = self.open_session(prompts[idx], max_new,
                                      arrival_ms=arr,
                                      profile_mode=profile_mode,
                                      slo=None if slos is None
                                      else slos[idx])
                active.append(s)
                idx += 1
            self.step()
            active = [s for s in active if not s.done]
        return [s.metrics for s in self.sessions[first:]]

    # -- telemetry ------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def server_stats(self) -> ServerStats:
        """Fleet-wide view: per-replica stats folded together plus the
        router's own counters.  Latency percentiles are recomputed from
        the pooled fleet sessions (degraded streams included)."""
        per = [srv.server_stats() for srv in self.replicas]
        agg = aggregate_server_stats(
            per,
            ttfts=[s.ttft_ms for s in self.sessions if s.ttft_ms is not None],
            e2es=[s.e2e_ms for s in self.sessions if s.e2e_ms is not None])
        agg.replicas = len(self.replicas)
        agg.dead_replicas = sum(self.dead)
        agg.route_policy = self.policy
        agg.degraded_streams = self.degraded_streams
        agg.rerouted_sessions = self.rerouted_sessions
        agg.affinity_hits = self.affinity_hits
        # degraded sessions belong to no replica; fold them in here —
        # completion count, stall buckets (device-only: pure compute)
        # and latency histogram samples alike
        for s in self.sessions:
            if not (self.owner.get(id(s)) == -1 and s.done
                    and not s.cancelled):
                continue
            agg.completed_streams += 1
            if s.metrics is not None:
                tl = s.metrics.timeline
                agg.stall_wall_ms += tl.t_ms
                agg.stall_device_ms += tl.compute_ms
                agg.stall_cloud_ms += tl.cloud_ms
                agg.stall_link_ms += tl.link_ms
                agg.stall_queue_ms += tl.queue_ms
                agg.stall_batch_wait_ms += tl.batch_wait_ms
                agg.stall_swap_ms += tl.swap_ms
                agg.stall_preempted_ms += tl.preempted_ms
                agg.stall_other_ms += tl.other_ms
            if s.ttft_ms is not None:
                hist_add(agg.hist_ttft_ms, s.ttft_ms)
            if s.e2e_ms is not None:
                hist_add(agg.hist_e2e_ms, s.e2e_ms)
            if (s.ttft_ms is not None and s.e2e_ms is not None
                    and s.n_emitted > 1):
                hist_add(agg.hist_tpot_ms,
                         (s.e2e_ms - s.ttft_ms) / (s.n_emitted - 1))
        agg.queue_depth += self.ext_queue_depth
        agg.rejected_requests += self.rejected_requests
        return agg

    def stats(self) -> dict:
        """Dict view of :meth:`server_stats` (the stable extras schema)."""
        return self.server_stats().as_dict()

    def replica_stats(self, idx: int) -> dict:
        """One replica's own stats dict (per-replica ``/metrics``),
        tagged with its index and liveness."""
        srv = self.replicas[idx]          # IndexError for a bad index
        d = srv.stats()
        d["replica"] = idx
        d["dead"] = self.dead[idx]
        return d
