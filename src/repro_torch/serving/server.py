"""Multi-tenant serving front-end: ``SyneraServer`` + ``DeviceSession``
(port of ``repro/serving/server.py``; the fleet helpers and the
router-facing session migration wait for the router's slice).

This is the non-blocking redesign of the serving layer (ROADMAP: scale
items).  The server owns the shared cloud side — ``CloudEngine``,
``VerificationAwareScheduler`` and one global discrete-event
``SimClock`` — while each ``DeviceSession`` wraps one device stream's
generation coroutine (``DeviceRuntime.generate_steps``) together with
its ``CloudClient`` handle.

Event-loop semantics
--------------------

Each session is a state machine::

    running --(yields verify, no slot yet)--> wait_slot
    running --(yields verify, has slot)-----> wait_cloud
    wait_slot --(prefill_done)--------------> wait_cloud
    wait_cloud --(verify_done)--------------> running
    running --(StopIteration)---------------> done

One ``step()`` of the loop first advances every *running* session until
it either finishes or parks on a cloud round trip — device draft
compute advances only that stream's private timeline — then executes
one scheduler iteration on the shared clock.  Because all runnable
streams are drained before the cloud runs, verification requests from
many sessions coexist in the scheduler's queues and one verify
iteration genuinely packs chunks from multiple slots (Algorithm 1 at
scale, §4.5).

Clocks: a session's device timeline is stream-relative; ``start_ms``
anchors it on the shared absolute clock.  A ``CloudCall`` sent at
device time ``t`` arrives at the cloud at ``start_ms + t + uplink``;
the scheduler fast-forwards to arrivals when idle and advances by
iteration cost when busy, so the reply's ``cloud_ms`` (completion -
arrival) includes genuine cross-stream queueing.  The stall the device
experiences is ``max(uplink + cloud_ms + downlink - overlap, 0)``,
exactly as in the blocking path — which is the ``concurrency=1``
special case and reproduces it metric-for-metric.
"""
from __future__ import annotations

from collections import deque
from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.serving.device import CloudReply, DeviceRuntime
from repro_torch.serving.engine import CloudEngine
from repro_torch.serving.link import CloudLatencyModel, SimClock
from repro_torch.serving.scheduler import VerificationAwareScheduler
from repro_torch.serving.synergy import CloudClient
from repro_torch.serving.trace import NULL_TRACER, hist_from, hist_new

RUNNING = "running"
WAIT_SLOT = "wait_slot"    # verify ready but prompt prefill not yet done
WAIT_CLOUD = "wait_cloud"  # verify in flight
DONE = "done"


@dataclass
class ServerStats:
    """Batching + memory telemetry for one serving run.

    The scheduler counters describe Algorithm-1 packing efficiency; the
    block-pool fields (meaningful when the engine runs
    ``cache_impl="paged"``) describe the memory-bound admission state —
    free/used/peak blocks, bytes actually backing live KV versus the
    dense reservation, and how many preemptions the pool forced.
    """
    iterations: int = 0
    prefill_iterations: int = 0
    verify_iterations: int = 0
    mean_verify_occupancy: float = 0.0
    max_verify_occupancy: int = 0
    mean_packed_tokens: float = 0.0
    sim_ms: float = 0.0
    waiting_sessions: int = 0          # admitted but not yet holding a slot
    # -- block pool (paged cache) --
    cache_impl: str = "dense"
    block_size: int = 0
    n_blocks: int = 0
    free_blocks: int = 0
    cached_free_blocks: int = 0        # ref-0 retained prefix blocks (LRU)
    used_blocks: int = 0
    peak_used_blocks: int = 0
    kv_cache_bytes: int = 0
    kv_bytes_in_use: int = 0
    kv_bytes_peak: int = 0
    preemptions: int = 0
    preempted_refed_tokens: int = 0
    # -- eviction disposition (host swap tier, serving/swap.py) --
    preempt_policy: str = "youngest"
    swap: bool = False                 # host swap tier enabled
    recompute_evictions: int = 0       # evictions that refeed from scratch
    swap_evictions: int = 0            # evictions parked in host memory
    swap_expirations: int = 0          # swap-ins degraded: shared lead died
    swapped_blocks: int = 0            # blocks currently in the host store
    swap_out_bytes: int = 0            # cumulative D2H payload bytes
    swap_in_bytes: int = 0             # cumulative H2D payload bytes
    # -- prefix sharing (share_prefix on a paged engine) --
    share_prefix: bool = False
    shared_blocks: int = 0             # blocks currently mapped by >1 slot
    dedupe_hit_blocks: int = 0         # cumulative blocks adopted, not alloc'd
    cow_copies: int = 0                # cumulative copy-on-write forks
    # -- persistent prefix cache (retain_prefix + content-addressed host) --
    retain_prefix: bool = False
    revived_blocks: int = 0            # cached-free blocks re-adopted
    reclaimed_blocks: int = 0          # cached-free blocks taken under pressure
    tail_shared_tokens: int = 0        # rows copied by partial-block tail share
    host_store_blocks: int = 0         # content-addressed host blocks (live)
    host_lru_blocks: int = 0           # ref-0 host blocks awaiting reuse
    host_dedupe_hits: int = 0          # swap-outs resolved by the host store
    host_adopted_blocks: int = 0       # admissions served from the host store
    adopt_in_bytes: int = 0            # cumulative H2D adoption payload bytes
    demoted_blocks: int = 0            # blocks demoted to host on release
    admission_swaps: int = 0           # idle streams swapped to admit prompts
    prefill_fed_tokens: int = 0        # cumulative tokens fed through prefill
    # -- request lifecycle (gateway front door, serving/gateway/) --
    clock: str = "sim"                 # "sim" (SimClock) | "wall" (RealClock)
    modeled_ms: float = 0.0            # shadow modeled time (== sim_ms on sim)
    queue_depth: int = 0               # admitted requests not yet in a session
    rejected_requests: int = 0         # 429s issued at the queue cap
    completed_streams: int = 0
    cancelled_streams: int = 0         # cancel()/client-disconnect teardowns
    # per-stream latency aggregates on the stream time axis (modeled ms
    # under SimClock; under the gateway's RealClock the same fields are
    # the server-side half of the modeled-vs-real cross-check)
    ttft_ms_mean: float = 0.0
    ttft_ms_p50: float = 0.0
    ttft_ms_p95: float = 0.0
    e2e_ms_mean: float = 0.0
    e2e_ms_p50: float = 0.0
    e2e_ms_p95: float = 0.0
    # -- fleet routing (serving/router.py) --
    replicas: int = 1                  # cloud replicas behind the router
    dead_replicas: int = 0             # replicas killed by fault injection
    route_policy: str = ""             # "" = no router in front
    degraded_streams: int = 0          # device-only completions (saturation)
    rerouted_sessions: int = 0         # sessions re-placed after replica death
    affinity_hits: int = 0             # placements that matched a cached prefix
    # -- stall attribution (serving/trace.py; completed streams only) --
    # exclusive buckets summed over completed streams' StreamTimelines;
    # they sum to stall_wall_ms (the summed end-to-end stream time)
    trace: bool = False                # tracer attached to this run
    stall_wall_ms: float = 0.0         # sum of completed streams' e2e time
    stall_device_ms: float = 0.0       # on-device SLM compute
    stall_cloud_ms: float = 0.0        # cloud iterations serving the stream
    stall_link_ms: float = 0.0         # unmasked WAN transfer
    stall_queue_ms: float = 0.0        # admission queueing before prefill
    stall_batch_wait_ms: float = 0.0   # behind other streams' iterations
    stall_swap_ms: float = 0.0         # host-swap transfers on the slot
    stall_preempted_ms: float = 0.0    # serving work a rewind threw away
    stall_other_ms: float = 0.0        # unattributed (tracing off / host)
    # -- latency histograms (Prometheus ladder; gateway /metrics) --
    hist_ttft_ms: dict = field(default_factory=hist_new)
    hist_tpot_ms: dict = field(default_factory=hist_new)
    hist_e2e_ms: dict = field(default_factory=hist_new)

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass
class DeviceSession:
    """One device stream: generation coroutine + cloud client + timing."""
    sid: int
    gen: object                    # generate_steps coroutine
    client: CloudClient
    start_ms: float                # absolute anchor of the device timeline
    state: str = RUNNING
    metrics: object = None         # DeviceMetrics once done
    pending_call: object = None    # CloudCall parked while waiting for slot
    arrival_abs_ms: float = 0.0    # absolute arrival of in-flight verify
    prefill_rid: int | None = None  # in-flight prompt prefill request id
    slots_used: list = field(default_factory=list)
    slo: object = None             # StreamSLO budgets (slo-aware preemption)
    cancelled: bool = False        # torn down via SyneraServer.cancel
    ttft_ms: float | None = None   # stream-relative time of first emit
    e2e_ms: float | None = None    # stream-relative completion time
    n_emitted: int = 0             # output tokens emitted so far
    trace_uid: int = -1            # tracer stream id (-1 when tracing off)
    trace_send_ms: float = 0.0     # absolute send time of in-flight verify

    @property
    def done(self) -> bool:
        return self.state == DONE


class SyneraServer:
    """Owns the cloud side and interleaves N concurrent device sessions."""

    def __init__(self, device: DeviceRuntime, engine: CloudEngine, *,
                 chunk: int = 32, sampling: str = "greedy",
                 latency: CloudLatencyModel | None = None,
                 clock: SimClock | None = None,
                 preempt_policy: str | None = None,
                 clamp_arrivals: bool = False,
                 tracer=None, replica: int = 0):
        self.device = device
        self.engine = engine
        self.sampling = sampling
        self.clock = clock or SimClock()
        # tracing (serving/trace.py): the tracer must live on the same
        # clock, or its timestamps would be on a different axis than the
        # events it records
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.replica = replica
        if self.tracer.enabled and self.tracer.clock is not self.clock:
            raise ValueError("tracer and server must share one clock")
        self.sched = VerificationAwareScheduler(
            engine, chunk=chunk, latency=latency, clock=self.clock,
            preempt_policy=preempt_policy, tracer=self.tracer,
            replica=replica)
        self.sessions: list[DeviceSession] = []
        self._by_req: dict[int, tuple[DeviceSession, str]] = {}
        self._fresh: deque[DeviceSession] = deque()  # opened, not yet run
        self._done_count = 0
        # -- gateway front-door state (serving/gateway/) ----------------
        # clamp_arrivals maps every cloud call's arrival to "now" on the
        # shared clock instead of start_ms + modeled device time: the
        # unpaced wall-clock mode, where requests are served as fast as
        # the host allows and the modeled device timeline is kept only
        # for the modeled-vs-real cross-check.
        self.clamp_arrivals = clamp_arrivals
        self.ext_queue_depth = 0       # gateway-held requests not yet opened
        self.rejected_requests = 0     # gateway 429s at the queue cap

    # ------------------------------------------------------------------
    def open_session(self, prompt, max_new: int, *,
                     arrival_ms: float | None = None,
                     profile_mode: bool = False,
                     slo: object = None,
                     emit=None) -> DeviceSession:
        """Register a new device stream.  ``arrival_ms`` anchors the
        stream's device timeline on the shared clock; default is "now"
        (the stream starts when it is admitted).  ``slo`` optionally
        carries the stream's latency budgets (``swap.StreamSLO``) for
        the slo-aware preemption policy.  ``emit(tokens, t_ms)`` is the
        per-token streaming hook (see ``DeviceRuntime.generate_steps``);
        the server always interposes to record the session's TTFT and
        emitted-token count, then chains to the caller's hook."""
        start = self.clock.now_ms if arrival_ms is None else arrival_ms
        client = CloudClient(self.sched, sampling=self.sampling, slo=slo)
        s = DeviceSession(sid=len(self.sessions), gen=None, client=client,
                          start_ms=start, slo=slo)
        tr = self.tracer
        trace_cb = None
        if tr.enabled:
            s.trace_uid = tr.stream_begin(
                "stream", start, replica=self.replica,
                meta={"sid": s.sid, "replica": self.replica,
                      "prompt_tokens": len(prompt), "max_new": max_new})

            def trace_cb(name, a, b, _tr=tr, _uid=s.trace_uid, _t0=start):
                _tr.stream_child(_uid, name, _t0 + a, _t0 + b)

        def _emit(tokens, t_ms, _s=s, _user=emit, _tr=tr):
            if _s.ttft_ms is None:
                _s.ttft_ms = t_ms
                if _tr.enabled and _s.trace_uid >= 0:
                    _tr.stream_instant(_s.trace_uid, "first_token",
                                       _s.start_ms + t_ms, n=len(tokens))
            elif _tr.enabled and _s.trace_uid >= 0:
                _tr.stream_instant(_s.trace_uid, "emit",
                                   _s.start_ms + t_ms, n=len(tokens))
            _s.n_emitted += len(tokens)
            if _user is not None:
                _user(tokens, t_ms)

        s.gen = self.device.generate_steps(prompt, max_new, use_cloud=True,
                                           profile_mode=profile_mode,
                                           emit=_emit, trace=trace_cb)
        self.sessions.append(s)
        self._fresh.append(s)
        return s

    # ------------------------------------------------------------------
    def _arrival(self, s: DeviceSession, call) -> float:
        """Absolute arrival of a cloud call on the shared clock:
        ``start_ms + modeled device time + uplink``, or "now" in the
        unpaced wall-clock mode (clamp_arrivals)."""
        if self.clamp_arrivals:
            return self.clock.now_ms
        return s.start_ms + call.arrival_ms

    def _submit_verify(self, s: DeviceSession, call) -> None:
        arr = self._arrival(s, call)
        rid = s.client.verify_async(call.seq, call.draft, call.dists,
                                    arrival_ms=arr)
        self._by_req[rid] = (s, "verify")
        s.arrival_abs_ms = arr
        if self.tracer.enabled:
            s.trace_send_ms = s.start_ms + call.send_ms
        s.state = WAIT_CLOUD

    def _advance(self, s: DeviceSession, reply) -> None:
        """Drive one session until it parks on the cloud or finishes."""
        while True:
            try:
                call = s.gen.send(reply)
            except StopIteration as e:
                s.metrics = e.value
                s.e2e_ms = e.value.timeline.t_ms
                s.state = DONE
                self._done_count += 1
                if self.tracer.enabled and s.trace_uid >= 0:
                    tl = e.value.timeline
                    self.tracer.stream_end(
                        s.trace_uid, s.start_ms + tl.t_ms,
                        meta={"wall_ms": tl.t_ms,
                              "tokens": len(e.value.tokens),
                              "buckets": tl.buckets()})
                had_slot = s.client.slot is not None
                s.client.release()
                if s.prefill_rid is not None and not had_slot:
                    # the stream never contacted the cloud again (e.g. no
                    # chunk offloaded): cancel the still-queued prompt
                    # prefill so it cannot later grab — and leak — a slot
                    self.sched.prefill_q = deque(
                        r for r in self.sched.prefill_q
                        if r.req_id != s.prefill_rid)
                    self._by_req.pop(s.prefill_rid, None)
                return
            reply = None
            if call.kind == "prefill":
                rid = s.client.prefill_async(
                    call.prompt, arrival_ms=self._arrival(s, call))
                s.prefill_rid = rid
                self._by_req[rid] = (s, "prefill")
                continue  # fire-and-forget: the device keeps drafting
            if s.client.slot is None:
                # first verify raced ahead of the prompt prefill
                s.pending_call = call
                s.state = WAIT_SLOT
            else:
                self._submit_verify(s, call)
            return

    # ------------------------------------------------------------------
    def cancel(self, session: DeviceSession | int) -> bool:
        """Tear down a mid-flight stream (client disconnect / explicit
        cancellation).  Clean teardown means *nothing leaks*:

        * the generation coroutine is closed (its device cache and
          timeline die with the frame),
        * every queued or in-flight scheduler request the session owns
          is purged *before* its slot is released (a re-assigned slot
          row must never execute a dead stream's work),
        * the slot release returns the row, decrefs/frees its blocks
          (shared prefix blocks survive for their siblings), and drops
          any host-swap state (``release_slot`` -> ``swap.drop``).

        Safe in any state: fresh (never ran), wait_slot (queued prefill
        cancelled), wait_cloud (verify purged), swapped-out, or holding
        shared/CoW blocks.  Returns False if the session was already
        done.  ``DeviceSession.metrics`` stays None for cancelled
        streams (the coroutine frame owns the partial metrics)."""
        s = self.sessions[session] if isinstance(session, int) else session
        if s.done:
            return False
        s.gen.close()
        s.state = DONE
        s.cancelled = True
        if self.tracer.enabled and s.trace_uid >= 0:
            self.tracer.stream_end(s.trace_uid, self.clock.now_ms,
                                   meta={"cancelled": True})
        s.pending_call = None
        self._done_count += 1
        try:
            self._fresh.remove(s)
        except ValueError:
            pass
        rids = {rid for rid, (sess, _) in self._by_req.items() if sess is s}
        for rid in rids:
            self._by_req.pop(rid)
        self.sched.cancel_requests(rids)
        s.client.release()
        return True

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One event-loop step: drain runnable sessions, then execute one
        scheduler iteration and deliver its completions.  Returns False
        once every session is done."""
        # Only freshly opened sessions start in `running`; every other
        # transition back to `running` is advanced inline when its event
        # is delivered below, so no full-session scan is needed.
        progressed = bool(self._fresh)
        while self._fresh:
            self._advance(self._fresh.popleft(), None)
        if self._done_count == len(self.sessions):
            return False

        t_before = self.clock.now_ms
        events = self.sched.run_iteration()
        for ev in events:
            entry = self._by_req.pop(ev.req_id, None)
            if entry is None:
                continue
            s, kind = entry
            s.client.on_event(ev)
            if kind == "prefill":
                s.slots_used.append(ev.slot)
                if self.tracer.enabled and s.trace_uid >= 0:
                    self.tracer.stream_instant(s.trace_uid, "slot_assigned",
                                               self.clock.now_ms, n=ev.slot)
                if s.done:
                    # the stream finished before its prefill executed
                    # (cancellation raced the iteration): free the slot
                    s.client.release()
                elif s.pending_call is not None:
                    call, s.pending_call = s.pending_call, None
                    self._submit_verify(s, call)
            else:
                now = self.clock.now_ms
                cloud_ms = now - s.arrival_abs_ms
                cloud_parts = None
                if self.tracer.enabled:
                    # decompose the request's in-flight window for the
                    # device coroutine's stall attribution, and stamp
                    # the round trip on the stream's async track
                    cloud_parts = self.tracer.window_parts(
                        s.arrival_abs_ms, now, replica=self.replica,
                        slot=ev.slot, vrid=ev.req_id,
                        prefill_rid=s.prefill_rid)
                    if s.trace_uid >= 0:
                        self.tracer.stream_child(
                            s.trace_uid, "verify_rt",
                            min(s.trace_send_ms, now), now)
                reply = CloudReply(result=ev.result, cloud_ms=cloud_ms,
                                   fed_tokens=s.client.last_fed_tokens,
                                   cloud_parts=cloud_parts)
                s.state = RUNNING
                self._advance(s, reply)
        if (not events and not progressed
                and self.clock.now_ms == t_before):
            raise RuntimeError(
                "SyneraServer stalled: sessions waiting but no scheduler "
                "event fired and the clock cannot advance")
        return self._done_count < len(self.sessions)

    def run(self) -> list:
        """Drive all open sessions to completion; returns their metrics
        in open order."""
        while self.step():
            pass
        return [s.metrics for s in self.sessions]

    # ------------------------------------------------------------------
    def serve(self, prompts, max_new: int, *,
              concurrency: int | None = None,
              arrivals: list[float] | None = None,
              profile_mode: bool = False,
              slos: list | None = None) -> list:
        """Admission-controlled convenience loop: keep at most
        ``concurrency`` sessions open (None = all at once), optionally
        anchoring each stream at an absolute ``arrivals[i]`` offset
        and attaching per-stream ``slos[i]`` latency budgets.
        Returns per-stream DeviceMetrics in prompt order."""
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

    # ------------------------------------------------------------------
    def server_stats(self) -> ServerStats:
        """Batching-efficiency counters from the shared scheduler plus
        block-pool utilization from the engine (paged cache)."""
        sched = self.sched
        occ = sched.verify_occupancy
        toks = sched.verify_tokens_fed
        pool = self.engine.pool_stats
        # one count per stream without a slot: sessions parked in
        # wait_slot and owners of still-queued prompt prefills overlap
        # (the queued prefill is what wait_slot waits on)
        waiting_ids = {id(s) for s in self.sessions if s.state == WAIT_SLOT}
        waiting_ids |= {id(self._by_req[r.req_id][0])
                        for r in sched.prefill_q
                        if r.req_id in self._by_req}
        waiting = len(waiting_ids)
        ttfts = [s.ttft_ms for s in self.sessions if s.ttft_ms is not None]
        e2es = [s.e2e_ms for s in self.sessions if s.e2e_ms is not None]
        tpots = [(s.e2e_ms - s.ttft_ms) / (s.n_emitted - 1)
                 for s in self.sessions
                 if s.ttft_ms is not None and s.e2e_ms is not None
                 and s.n_emitted > 1]
        # stall buckets: completed streams' timelines (each sums to its
        # own t_ms, so the totals sum to stall_wall_ms by construction)
        tls = [s.metrics.timeline for s in self.sessions
               if s.done and not s.cancelled and s.metrics is not None]

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        return ServerStats(
            trace=self.tracer.enabled,
            stall_wall_ms=sum(t.t_ms for t in tls),
            stall_device_ms=sum(t.compute_ms for t in tls),
            stall_cloud_ms=sum(t.cloud_ms for t in tls),
            stall_link_ms=sum(t.link_ms for t in tls),
            stall_queue_ms=sum(t.queue_ms for t in tls),
            stall_batch_wait_ms=sum(t.batch_wait_ms for t in tls),
            stall_swap_ms=sum(t.swap_ms for t in tls),
            stall_preempted_ms=sum(t.preempted_ms for t in tls),
            stall_other_ms=sum(t.other_ms for t in tls),
            hist_ttft_ms=hist_from(ttfts),
            hist_tpot_ms=hist_from(tpots),
            hist_e2e_ms=hist_from(e2es),
            clock=("wall" if hasattr(self.clock, "modeled_ms") else "sim"),
            modeled_ms=getattr(self.clock, "modeled_ms", self.clock.now_ms),
            queue_depth=self.ext_queue_depth + len(self._fresh) + waiting,
            rejected_requests=self.rejected_requests,
            completed_streams=sum(1 for s in self.sessions
                                  if s.done and not s.cancelled),
            cancelled_streams=sum(1 for s in self.sessions if s.cancelled),
            ttft_ms_mean=float(np.mean(ttfts)) if ttfts else 0.0,
            ttft_ms_p50=pct(ttfts, 50), ttft_ms_p95=pct(ttfts, 95),
            e2e_ms_mean=float(np.mean(e2es)) if e2es else 0.0,
            e2e_ms_p50=pct(e2es, 50), e2e_ms_p95=pct(e2es, 95),
            iterations=sched.iterations,
            prefill_iterations=sched.prefill_iterations,
            verify_iterations=sched.verify_iterations,
            mean_verify_occupancy=sched.mean_verify_occupancy,
            max_verify_occupancy=max(occ) if occ else 0,
            mean_packed_tokens=(sum(toks) / len(toks)) if toks else 0.0,
            sim_ms=self.clock.now_ms,
            waiting_sessions=waiting,
            cache_impl=pool["cache_impl"],
            block_size=pool["block_size"],
            n_blocks=pool["n_blocks"],
            free_blocks=pool["free_blocks"],
            used_blocks=pool["used_blocks"],
            peak_used_blocks=pool["peak_used_blocks"],
            kv_cache_bytes=pool["kv_cache_bytes"],
            kv_bytes_in_use=pool["kv_bytes_in_use"],
            kv_bytes_peak=pool["kv_bytes_peak"],
            preemptions=sched.preemptions,
            preempted_refed_tokens=sched.preempted_refed_tokens,
            preempt_policy=sched.preempt_policy,
            swap=pool["swap"],
            recompute_evictions=sched.recompute_evictions,
            swap_evictions=sched.swap_evictions,
            swap_expirations=sched.swap_expirations,
            swapped_blocks=pool["swapped_blocks"],
            swap_out_bytes=pool["swap_out_bytes"],
            swap_in_bytes=pool["swap_in_bytes"],
            share_prefix=pool["share_prefix"],
            shared_blocks=pool["shared_blocks"],
            dedupe_hit_blocks=pool["dedupe_hit_blocks"],
            cow_copies=pool["cow_copies"],
            cached_free_blocks=pool["cached_free_blocks"],
            retain_prefix=pool["retain_prefix"],
            revived_blocks=pool["revived_blocks"],
            reclaimed_blocks=pool["reclaimed_blocks"],
            tail_shared_tokens=pool["tail_shared_tokens"],
            host_store_blocks=pool["host_store_blocks"],
            host_lru_blocks=pool["host_lru_blocks"],
            host_dedupe_hits=pool["host_dedupe_hits"],
            host_adopted_blocks=pool["host_adopted_blocks"],
            adopt_in_bytes=pool["adopt_in_bytes"],
            demoted_blocks=pool["demoted_blocks"],
            admission_swaps=sched.admission_swaps,
            prefill_fed_tokens=sched.prefill_fed_tokens,
        )

    def stats(self) -> dict:
        """Dict view of :meth:`server_stats` (the stable extras schema)."""
        return self.server_stats().as_dict()
