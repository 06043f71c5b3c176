"""Verification-aware scheduler (Synera §4.5, Algorithm 1); a port of
``repro/serving/scheduler.py`` (framework-free, carried over whole: its
block-pool and swap branches stay inert while ``engine.allocator`` is
None, i.e. on the dense engine).

Batching policy over the CloudEngine:

* Prefill requests are prioritized: while any are queued *and a slot is
  free*, an iteration executes a prefill batch (lines 5-11 of
  Algorithm 1).  When prefills are queued but no slot is free, the
  iteration falls through to verification work — completing
  verifications is what eventually releases slots, so stalling here
  would deadlock the head of the line.
* Otherwise, queued verification requests are batched.  Each request is
  a *partial prefill*: device-accepted-but-uncached tokens followed by
  pending-verify draft tokens, executed over the slot's cached prefix.
  Requests are segmented into fixed-size chunks (Sarathi-style, default
  32) so iterations stay uniform (lines 12-21).  One iteration packs at
  most one chunk per slot but chunks from *many* slots — this is where
  multi-tenant batching happens.
* When a request's last chunk completes, the draft tokens are verified
  ("draft & verify") and the result is emitted.

Device residency (the perf contract, docs/serving_api.md): by default
(``fused=True``) the scheduler consumes the engine's fused rows —
per-row argmax ids, the gathered probability of each known next token
(the scheduler passes a ``targets`` plane alongside tokens/positions),
and top-k compressed sampling support — so no full-vocab tensor crosses
the host boundary per verify iteration and requests retain only O(gamma
* K) host state.  ``fused=False`` keeps the pre-fusion host-numpy path
(full (slots, chunk, V) logits round trip + numpy verifier) for
benchmarking and identity testing; both modes emit byte-identical
greedy token streams.

Time: the scheduler shares a ``SimClock`` (serving/link.py) with
whoever drives it (the ``SyneraServer`` event loop, or a private clock
for the legacy blocking facade).  Requests carry an absolute
``arrival_ms``; a request is only admitted into an iteration once the
clock has reached its arrival.  When the scheduler is idle it
fast-forwards to the earliest queued arrival, and when it executes a
batch it advances the clock by the iteration's modeled cost — so
completion times measured on this clock reflect genuine queueing behind
other streams' work, not a per-request private accumulator.

Memory pressure (paged engines): verify iterations reserve their block
growth and, when the pool runs dry, evict a victim chosen by the
pluggable policy (serving/swap.py: youngest | most-blocks | slo-aware)
with a per-victim disposition — host-swap its blocks (restored
bit-identical later; nothing refeeds) when the modeled D2H+H2D round
trip beats the modeled re-prefill, recompute-eviction otherwise.
Swapped streams are restored FIFO ahead of new admissions.

The scheduler also supports plain decode streams (the cloud-centric
baseline) through ``decode_iteration``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import verifier as V
from repro_torch.serving.engine import CloudEngine
from repro_torch.serving.link import CloudLatencyModel, SimClock
from repro_torch.serving.swap import PREEMPT_POLICIES, pick_victim
from repro_torch.serving.trace import NULL_TRACER


@dataclass
class PrefillRequest:
    req_id: int
    tokens: np.ndarray            # (T,) prompt
    slot: int = -1
    arrival_ms: float = 0.0       # absolute arrival on the shared clock
    # leading prompt tokens mapped from the shared prefix index at
    # admission (share_prefix): already cached, so the batch feeds (and
    # the latency model charges) only tokens[shared:]
    shared: int = 0
    # optional per-stream latency budgets (serving/swap.StreamSLO),
    # consumed by the "slo-aware" preemption policy
    slo: object = None


@dataclass
class VerifyRequest:
    req_id: int
    slot: int
    uncached: np.ndarray          # device-accepted tokens not yet cloud-cached
    draft: np.ndarray             # (gamma,) pending-verify tokens
    q_sparse: list                # compressed SLM dists per draft position
    sampling: str = "greedy"
    start_pos: int = 0            # absolute position of uncached[0]
    arrival_ms: float = 0.0       # absolute arrival on the shared clock
    # full accepted stream (prompt + output).  When given, the request is
    # *restartable*: if its slot is preempted (paged pool dry), the
    # scheduler rewinds the request and re-derives ``uncached`` from the
    # new cache frontier (a from-scratch partial prefill) instead of
    # aborting the stream.  CloudClient always supplies it.
    seq: np.ndarray | None = None
    # internal
    fed: int = 0
    rows: list = field(default_factory=list)
    # rows entries: (abs_pos, fused (tok, p_draft, topk_idx, topk_val))
    # in fused mode, (abs_pos, full logits row) in legacy mode


@dataclass
class SchedulerEvent:
    kind: str                     # "prefill_done" | "verify_done"
    req_id: int
    slot: int
    result: object = None         # VerifyResult for verify_done
    last_logits: np.ndarray = None


class VerificationAwareScheduler:
    def __init__(self, engine: CloudEngine, *, chunk: int = 32,
                 latency: CloudLatencyModel | None = None,
                 rng: np.random.Generator | None = None,
                 clock: SimClock | None = None,
                 fused: bool = True,
                 preempt_policy: str | None = None,
                 tracer=None, replica: int = 0):
        self.engine = engine
        self.chunk = chunk
        self.fused = fused
        # tracing (serving/trace.py): every clock charge below becomes a
        # typed span tagged with the request ids / slot it served; the
        # NULL_TRACER default keeps the disabled path allocation-free
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.replica = replica
        if self.tracer.enabled:
            alloc = getattr(engine, "allocator", None)
            if alloc is not None:
                alloc.tracer = self.tracer
                alloc.trace_replica = replica
            swp = getattr(engine, "swap_manager", None)
            if swp is not None:
                swp.tracer = self.tracer
                swp.trace_replica = replica
        policy = (preempt_policy
                  or getattr(getattr(engine, "cfg", None),
                             "preempt_policy", None)
                  or "youngest")
        if policy not in PREEMPT_POLICIES:
            raise ValueError(f"unknown preempt_policy {policy!r}; "
                             f"have {PREEMPT_POLICIES}")
        self.preempt_policy = policy
        # host swap tier (engine-owned; None without --swap / kv_swap)
        self.swap = getattr(engine, "swap_manager", None)
        self.latency = latency or CloudLatencyModel()
        self.rng = rng or np.random.default_rng(0)
        self.clock = clock or SimClock()
        self.prefill_q: deque[PrefillRequest] = deque()
        self.verify_q: deque[VerifyRequest] = deque()
        self.active_verify: list[VerifyRequest] = []
        # FIFO: released slots go to the back so churn round-robins over
        # the physical batch rows instead of one slot absorbing it all
        self.free_slots: deque[int] = deque(range(engine.max_slots))
        self.cloud_len = np.zeros(engine.max_slots, np.int64)
        self.last_row: dict[int, np.ndarray] = {}  # slot -> last prefill row
        self.iterations = 0           # iterations that executed a batch
        self.prefill_iterations = 0
        self.verify_iterations = 0
        self.verify_occupancy: list[int] = []  # slots packed per verify iter
        self.verify_tokens_fed: list[int] = []  # tokens packed per verify iter
        self._req_counter = 0
        # paged-cache policy state: admission order (for youngest-first
        # preemption), per-slot prompt/SLO metadata (swap re-matching and
        # slo-aware victim selection) and preemption telemetry
        self.slot_age = np.full(engine.max_slots, -1, np.int64)
        self._admit_counter = 0
        self.slot_prompt: dict[int, np.ndarray] = {}
        self.slot_slo: dict[int, tuple] = {}   # slot -> (ttft_abs, ddl_abs)
        self._first_emit: set[int] = set()     # slots past their first emit
        self.recompute_evictions = 0
        self.swap_evictions = 0
        self.swap_expirations = 0   # swap-ins degraded: shared lead died
        self.preempted_refed_tokens = 0
        self.admission_swaps = 0    # proactive swap-outs at admission
        self.prefill_fed_tokens = 0  # cumulative prompt tokens actually fed
        # consecutive verify iterations that deferred EVERY chunk with
        # nothing evicted and nothing else executing — a growing streak
        # means no stream can ever free blocks (all holders
        # non-restartable), which must fail loudly, not spin the clock
        self._defer_streak = 0

    @property
    def sim_ms(self) -> float:
        return self.clock.now_ms

    @property
    def preemptions(self) -> int:
        """Total evictions, whatever the disposition."""
        return self.recompute_evictions + self.swap_evictions

    def slot_slack_ms(self, slot: int, now: float) -> float:
        """Remaining SLO budget of the stream on ``slot``: time to its
        TTFT bound (until the first verified emission) or completion
        deadline, whichever binds.  ``inf`` without an SLO — such
        streams are the preferred victims under ``slo-aware``."""
        slo = self.slot_slo.get(slot)
        if slo is None:
            return float("inf")
        ttft_abs, deadline_abs = slo
        lim = (deadline_abs if slot in self._first_emit
               else min(ttft_abs, deadline_abs))
        return lim - now

    def next_req_id(self) -> int:
        """Globally unique request id (unique per scheduler, so events
        from concurrent clients never collide)."""
        self._req_counter += 1
        return self._req_counter

    @property
    def mean_verify_occupancy(self) -> float:
        occ = self.verify_occupancy
        return float(np.mean(occ)) if occ else 0.0

    # ------------------------------------------------------------------
    def submit_prefill(self, req: PrefillRequest):
        self.prefill_q.append(req)

    def submit_verify(self, req: VerifyRequest):
        assert self.chunk >= len(req.draft) + 1, \
            "Sarathi chunk must cover a draft chunk (+1) so rejected-draft " \
            "cache entries are overwritten before any query can attend to them"
        if self.fused:
            rows_max = getattr(self.engine, "verify_rows_max", self.chunk)
            assert rows_max >= len(req.draft) + 1, \
                "engine.verify_rows_max must cover gamma+1 verification rows"
        req.start_pos = int(self.cloud_len[req.slot])
        self.verify_q.append(req)

    def release_slot(self, slot: int):
        if self.swap is not None:
            self.swap.drop(slot)       # session over: host payload gone
        self.slot_prompt.pop(slot, None)
        self.slot_slo.pop(slot, None)
        self._first_emit.discard(slot)
        self.engine.reset_slot(slot)
        if self.swap is not None:
            # exit-time demotion to the content-addressed host store is
            # a D2H peek: charge it to the modeled link
            nbytes = self.swap.take_uncharged()
            t0 = self.clock.now_ms
            self.clock.advance(self.latency.host_transfer_ms(nbytes))
            if self.tracer.enabled and nbytes:
                self.tracer.span(t0, self.clock.now_ms, "swap_demote",
                                 replica=self.replica, slot=slot,
                                 nbytes=nbytes)
        self.cloud_len[slot] = 0
        self.slot_age[slot] = -1
        self.free_slots.append(slot)   # FIFO: reuse round-robins over rows

    def has_work(self) -> bool:
        return bool(self.prefill_q or self.verify_q or self.active_verify)

    def cancel_requests(self, req_ids: set) -> None:
        """Drop every queued or in-flight request in ``req_ids`` (client
        cancellation / disconnect).  Request state is simply discarded —
        the caller is responsible for releasing the slot afterwards
        (``release_slot``), which frees blocks, drops swap state and
        decrefs shared prefixes.  Purging *before* the release matters:
        a freed slot row may be re-assigned to a new stream, and a stale
        request must never execute against the new owner's cache."""
        if not req_ids:
            return
        self.prefill_q = deque(r for r in self.prefill_q
                               if r.req_id not in req_ids)
        self.verify_q = deque(r for r in self.verify_q
                              if r.req_id not in req_ids)
        self.active_verify = [r for r in self.active_verify
                              if r.req_id not in req_ids]

    def export_requests(self, req_ids: set) -> list[VerifyRequest]:
        """Remove and return the verify requests in ``req_ids`` (replica
        death: the router re-places a dying replica's sessions on
        survivors).  Unlike :meth:`cancel_requests` the requests come
        back to the caller: each carries its full accepted stream in
        ``seq`` — the same restartability contract the recompute
        eviction path relies on — so the survivor can re-prefill the
        stream from scratch and re-run the parked verify on top.
        Queued prompt prefills in ``req_ids`` are simply dropped; the
        re-placement re-prefills the full stream anyway."""
        if not req_ids:
            return []
        out = [r for r in list(self.active_verify) + list(self.verify_q)
               if r.req_id in req_ids]
        self.cancel_requests(req_ids)
        return out

    # ------------------------------------------------------------------
    def run_iteration(self) -> list[SchedulerEvent]:
        """One scheduling iteration (one trip through Algorithm 1's loop).

        Returns completion events.  If no queued request has arrived yet
        (shared-clock semantics), fast-forwards the clock to the next
        arrival and returns [] — callers loop while ``has_work()``.
        """
        self._swap_in_ready()
        now = self.clock.now_ms
        if self.prefill_q and self.free_slots and \
                any(r.arrival_ms <= now for r in self.prefill_q):
            evs = self._prefill_iteration(now)
            if evs:
                self.iterations += 1
                return evs
        if self.verify_q or self.active_verify:
            evs = self._verify_iteration(now)
            if evs is not None:
                self.iterations += 1
                return evs
        # Nothing executable at `now`: fast-forward to the next *future*
        # arrival.  Requests that have already arrived but are blocked
        # (e.g. a prefill with no free slot) must not pin the clock —
        # unblocking them needs an external action (slot release), not
        # time.
        future = [a for a in
                  ([r.arrival_ms for r in self.prefill_q]
                   + [r.arrival_ms for r in self.verify_q])
                  if a > now]
        if future:
            t0 = self.clock.now_ms
            self.clock.advance_to(min(future))
            if self.tracer.enabled and self.clock.now_ms > t0:
                self.tracer.span(t0, self.clock.now_ms, "idle",
                                 replica=self.replica)
        return []

    # -- prefill (lines 5-11) ------------------------------------------
    def _swap_in_reserve(self) -> int:
        """Blocks fresh admissions must leave untouched for the
        FIFO-head swapped stream: without this, a continuous arrival
        stream could consume every freed block the moment it appears
        and starve a large swapped stream's return indefinitely."""
        if self.swap is None:
            return 0
        slots = self.swap.swapped_slots
        return self.swap.blocks_needed(slots[0]) if slots else 0

    def _prefill_iteration(self, now: float) -> list[SchedulerEvent]:
        alloc = getattr(self.engine, "allocator", None)
        blocks_exhausted = False
        batch: list[PrefillRequest] = []
        rest: deque[PrefillRequest] = deque()
        while self.prefill_q:
            req = self.prefill_q.popleft()
            # admission is memory-bound on a paged engine: a free batch
            # row AND enough free blocks for the prompt — minus any
            # leading blocks the prefix index already holds (a shared
            # system prompt costs its blocks once, not once per stream).
            # On dense the slot row is the only resource.  Once one
            # arrived request is deferred for blocks, later
            # (block-needing) requests are too — FCFS, so a steady
            # stream of small prompts cannot starve a large one
            if req.arrival_ms > now or not self.free_slots:
                rest.append(req)    # cheap defers skip the prefix probe
                continue
            if blocks_exhausted:
                # FCFS tail: a paged prompt always needs >= 1 fresh
                # block (matching caps at len-1 tokens), so nothing
                # behind the first block-deferred request can admit —
                # skip its probe too
                rest.append(req)
                continue
            need = 0
            matched: list = []
            if alloc is not None:
                full_need = alloc.blocks_for(len(req.tokens))
                if full_need > alloc.n_blocks:
                    # can never be satisfied, not even by draining the
                    # pool (shared blocks may vanish with their owners):
                    # fail with the sizing contract instead of stalling
                    raise RuntimeError(
                        f"paged KV pool too small for prompt of "
                        f"{len(req.tokens)} tokens: needs {full_need} "
                        f"blocks, pool has {alloc.n_blocks} total "
                        f"(block_size={alloc.block_size}) — grow "
                        f"pool_blocks")
                matched = alloc.match_prefix(req.tokens)
                need = full_need - len(matched)
                # supply counts cached-free (reclaimable) blocks, minus
                # the matched ones this prompt is about to revive
                avail = (alloc.allocatable_blocks(matched)
                         - self._swap_in_reserve())
                if need > avail and self._admission_swap(need - avail):
                    # swap-aware admission: an idle cold stream made room
                    avail = (alloc.allocatable_blocks(matched)
                             - self._swap_in_reserve())
                if need > avail:
                    blocks_exhausted = True
                    rest.append(req)
                    continue
            req.slot = self.free_slots.popleft()
            self._admit_counter += 1
            self.slot_age[req.slot] = self._admit_counter
            # prompt retained for the swap tier (shared-lead re-matching),
            # SLO budgets anchored at arrival for slo-aware preemption
            self.slot_prompt[req.slot] = np.asarray(req.tokens)
            if req.slo is not None:
                self.slot_slo[req.slot] = (
                    req.arrival_ms + req.slo.ttft_ms,
                    req.arrival_ms + req.slo.deadline_ms)
            if alloc is not None:
                # allocate (and prefix-share) eagerly so the request
                # admitted next in this same loop sees the live free
                # count AND can adopt this prompt's just-registered
                # blocks; the probe above is still valid (nothing is
                # released between probe and admission)
                req.shared = self.engine.alloc_prompt(req.slot, req.tokens,
                                                      bids=matched)
            batch.append(req)
        self.prefill_q = rest
        if not batch:
            return []  # wait for a free slot
        self._defer_streak = 0         # admission is forward progress

        B = self.engine.max_slots
        C = max(len(r.tokens) for r in batch)
        tokens = np.zeros((B, C), np.int32)
        positions = np.full((B, C), -1, np.int32)
        for r in batch:
            T, m = len(r.tokens), r.shared
            # columns align with absolute positions; a shared prefix is
            # leading padding.  This is what keeps same-batch adoption
            # safe when the bucket ladder splits a wide prompt batch
            # into sequential sub-chunks: sub-chunk k scatters position
            # range k for EVERY slot before any later sub-chunk's rows
            # attend over it, so an adopter's suffix never reads prefix
            # positions its filler has not yet written
            tokens[r.slot, m:T] = r.tokens[m:]
            positions[r.slot, m:T] = np.arange(m, T)
        # one full-vocab row per slot crosses to the host here (the
        # sampling verifier's pre-draft row); verify iterations never
        # transfer a vocab-sized tensor
        t_exec0 = self.clock.now_ms
        b0 = getattr(self.engine, "bytes_to_host", 0)
        last_rows = self.engine.prefill(tokens, positions)
        moved = getattr(self.engine, "bytes_to_host", 0) - b0

        events = []
        # shared prefix tokens are cache hits: neither fed nor charged;
        # blocks adopted from the content-addressed host store are
        # charged as H2D transfers instead (take_uncharged)
        total = sum(len(r.tokens) - r.shared for r in batch)
        self.prefill_fed_tokens += total
        adopted = self.swap.take_uncharged() if self.swap is not None else 0
        self.clock.advance(self.latency.prefill_ms(total)
                           + self.latency.host_transfer_ms(moved + adopted))
        self.prefill_iterations += 1
        if self.tracer.enabled:
            self.tracer.span(t_exec0, self.clock.now_ms, "prefill",
                             replica=self.replica,
                             rids=tuple(r.req_id for r in batch),
                             tokens=total, nbytes=moved + adopted)
        for r in batch:
            T = len(r.tokens)
            self.cloud_len[r.slot] = T
            self.last_row[r.slot] = last_rows[r.slot]
            events.append(SchedulerEvent(
                "prefill_done", r.req_id, r.slot,
                last_logits=last_rows[r.slot]))
        return events

    # -- verification partial prefill (lines 12-21) ---------------------
    def _verify_iteration(self, now: float) -> list[SchedulerEvent] | None:
        """Returns events for the executed batch, or None if no verify
        chunk was admissible at ``now`` (caller decides how to wait)."""
        still: deque[VerifyRequest] = deque()
        while self.verify_q:
            r = self.verify_q.popleft()
            if r.arrival_ms <= now:
                self.active_verify.append(r)
            else:
                still.append(r)
        self.verify_q = still

        B = self.engine.max_slots
        C = self.chunk
        R = getattr(self.engine, "verify_rows_max", C) if self.fused else 0
        tokens = np.zeros((B, C), np.int32)
        positions = np.full((B, C), -1, np.int32)
        targets = np.full((B, C), -1, np.int32)
        sel_idx = np.full((B, max(R, 1)), -1, np.int32)
        kept: dict[int, list[int]] = {}  # slot -> kept local row indices
        feeding: list[tuple[VerifyRequest, int, int]] = []
        used_slots = set()
        for req in self.active_verify:
            if req.slot in used_slots:
                continue  # one chunk per slot per iteration
            if self._slot_swapped(req.slot):
                continue  # cache on the host: waits for swap-in
            seq = np.concatenate([req.uncached, req.draft]).astype(np.int32)
            n = min(C, len(seq) - req.fed)
            if n <= 0:
                continue
            tokens[req.slot, :n] = seq[req.fed:req.fed + n]
            positions[req.slot, :n] = (req.start_pos + req.fed
                                       + np.arange(n))
            if self.fused:
                # row i predicts seq[fed+i+1]: the verifier's accept test
                # needs its probability, gathered on device.  The last
                # row of the request (the bonus row) has no target.
                nt = min(n, len(seq) - req.fed - 1)
                targets[req.slot, :nt] = seq[req.fed + 1:req.fed + 1 + nt]
                # rows the verifier will consume: the last gamma+1 of the
                # request — the device computes p/top-k only for these
                keep_from = len(seq) - len(req.draft) - 1
                local = [i for i in range(n) if req.fed + i >= keep_from]
                kept[req.slot] = local
                sel_idx[req.slot, :len(local)] = local
            feeding.append((req, req.fed, n))
            used_slots.add(req.slot)

        if not feeding:
            return None
        if not self._reserve_blocks(feeding, tokens, positions, targets,
                                    sel_idx, kept):
            # every admissible chunk was preempted away: charge the
            # scheduling work so the shared clock (and the server's
            # stall detector) sees progress, and retry next iteration
            t0 = self.clock.now_ms
            self.clock.advance(self.latency.ms_scheduler)
            if self.tracer.enabled:
                self.tracer.span(t0, self.clock.now_ms, "sched",
                                 replica=self.replica)
            return None
        t_exec0 = self.clock.now_ms
        b0 = getattr(self.engine, "bytes_to_host", 0)
        if self.fused:
            need_dists = any(r.sampling != "greedy" for r, _, _ in feeding)
            rows = self.engine.feed(tokens, positions, targets, sel_idx,
                                    need_dists=need_dists)
        else:
            logits = self.engine.feed_logits(tokens, positions)
        moved = getattr(self.engine, "bytes_to_host", 0) - b0
        total = sum(n for _, _, n in feeding)
        self.clock.advance(self.latency.iteration_ms(total)
                           + self.latency.host_transfer_ms(moved))
        self.verify_iterations += 1
        self.verify_occupancy.append(len(feeding))
        self.verify_tokens_fed.append(total)
        if self.tracer.enabled:
            self.tracer.span(t_exec0, self.clock.now_ms, "verify",
                             replica=self.replica,
                             rids=tuple(r.req_id for r, _, _ in feeding),
                             tokens=total, nbytes=moved)

        events = []
        for req, fed0, n in feeding:
            gamma = len(req.draft)
            seq_len = len(req.uncached) + gamma
            if self.fused:
                for r, i in enumerate(kept[req.slot]):
                    req.rows.append((req.start_pos + fed0 + i, (
                        int(rows.token_id[req.slot, r]),
                        float(rows.p_draft[req.slot, r]),
                        rows.topk_idx[req.slot, r],
                        rows.topk_val[req.slot, r])))
            else:
                keep_from = seq_len - gamma - 1
                for i in range(n):
                    idx = fed0 + i
                    if idx >= keep_from:
                        req.rows.append((req.start_pos + idx,
                                         logits[req.slot, i]))
            req.fed = fed0 + n
            self.cloud_len[req.slot] = req.start_pos + req.fed
            if req.fed >= seq_len:
                events.append(self._finish_verify(req))
        self.active_verify = [r for r in self.active_verify
                              if r.fed < len(r.uncached) + len(r.draft)]
        return events

    # -- paged-pool admission + preemption ------------------------------
    def _reserve_blocks(self, feeding, tokens, positions, targets,
                        sel_idx, kept) -> bool:
        """Memory admission for one verify iteration on a paged engine.

        Ensures the block pool can supply every feeding slot's growth;
        when it cannot, the *youngest* block-holding stream is preempted
        (recompute-style eviction: its blocks return to the pool, its
        cloud frontier rewinds to zero, and its pending requests restart
        as from-scratch partial prefills — re-derived from ``req.seq``
        the next time they are fed).  The oldest block holder is never
        evicted, which guarantees forward progress.  Returns False when
        the eviction emptied the feeding set (retry next iteration);
        no-op (True) on dense engines.
        """
        alloc = getattr(self.engine, "allocator", None)
        if alloc is None:
            return True

        def demand(entry):
            req, fed0, n = entry
            lo = req.start_pos + fed0
            upto = min(lo + n, self.engine.s_max)
            # growth blocks plus copy-on-write forks: a chunk that wraps
            # into (or otherwise writes) a block still shared with a
            # sibling must clone it before writing
            return (alloc.needed(req.slot, upto)
                    + alloc.cow_demand(req.slot, lo, lo + n))

        evicted = False
        while feeding:
            if sum(demand(e) for e in feeding) <= alloc.allocatable_blocks():
                self._defer_streak = 0
                return True
            victim = self._pick_victim()
            if victim is not None and self._evict(victim, feeding, tokens,
                                                  positions, targets,
                                                  sel_idx, kept):
                evicted = True
                continue
            # No evictable stream (the only holder is protected or not
            # restartable): defer the youngest feeding chunk that
            # actually needs blocks — zero-demand chunks write into
            # their last partial block and can always proceed (and
            # finishing them is what releases blocks).  The deferred
            # request stays queued untouched.
            needy = [e for e in feeding if demand(e) > 0]
            entry = max(needy, key=lambda e: self.slot_age[e[0].slot])
            req = entry[0]
            own = int(alloc.n_blocks_of[req.slot])
            if len(feeding) == 1 and alloc.used_blocks == own:
                raise RuntimeError(
                    f"paged KV pool too small for a single stream: chunk "
                    f"needs {demand(entry)} blocks beyond the {own} it "
                    f"holds, pool has {alloc.free_blocks}/"
                    f"{alloc.n_blocks} free (block_size="
                    f"{alloc.block_size}) — grow pool_blocks")
            self._withdraw(entry, feeding, tokens, positions, targets,
                           sel_idx, kept)
        # the whole batch was deferred: legitimate while other work
        # (or an eviction) can still free blocks, but an unbroken
        # streak of all-deferred iterations means nothing ever will —
        # every reserve success, eviction, or executed batch resets it
        self._defer_streak = 0 if evicted else self._defer_streak + 1
        if self._defer_streak > 4 * self.engine.max_slots + 16:
            raise RuntimeError(
                f"paged KV pool deadlocked: every verify chunk deferred "
                f"for {self._defer_streak} consecutive iterations with "
                f"no evictable stream ({alloc.free_blocks}/"
                f"{alloc.n_blocks} blocks free, block_size="
                f"{alloc.block_size}).  Streams submitted without "
                f"VerifyRequest.seq cannot be preempted — grow "
                f"pool_blocks or supply seq")
        return False

    @staticmethod
    def _withdraw(entry, feeding, tokens, positions, targets, sel_idx,
                  kept) -> None:
        """Pull one chunk out of the current batch without touching its
        request state — it simply waits for a later iteration."""
        slot = entry[0].slot
        tokens[slot, :] = 0
        positions[slot, :] = -1
        targets[slot, :] = -1
        sel_idx[slot, :] = -1
        kept.pop(slot, None)
        feeding.remove(entry)

    def _slot_restartable(self, slot: int) -> bool:
        """A slot can be preempted only if every pending request for it
        carries the full accepted stream (``seq``) so the scheduler can
        re-derive the partial prefill from a cold cache."""
        return all(r.seq is not None
                   for r in list(self.active_verify) + list(self.verify_q)
                   if r.slot == slot)

    def _slot_swapped(self, slot: int) -> bool:
        """Whether ``slot``'s KV lives in the host store right now (the
        manager's stream table is the single source of truth)."""
        return self.swap is not None and self.swap.holds(slot)

    def _swap_possible(self, slot: int) -> bool:
        return self.swap is not None and self.swap.plan(slot) is not None

    def _pick_victim(self) -> int | None:
        """Block-holding victim by the configured policy (never the
        oldest holder — forward progress).  A candidate must either be
        restartable (recompute-eviction re-derives its partial prefill
        from ``VerifyRequest.seq``) or swappable (the host tier keeps
        its state, no restart needed)."""
        alloc = self.engine.allocator
        holders = [s for s in range(self.engine.max_slots)
                   if alloc.n_blocks_of[s] > 0]
        if len(holders) <= 1:
            return None
        oldest = min(holders, key=lambda s: self.slot_age[s])
        cands = [s for s in holders
                 if s != oldest and (self._slot_restartable(s)
                                     or self._swap_possible(s))]
        if not cands:
            return None
        return pick_victim(self.preempt_policy, cands, self)

    def _admission_swap(self, deficit: int) -> bool:
        """Swap-aware admission: make room for a queued prompt by swapping
        *idle* block holders (no pending verify work) to the host tier,
        rather than turning the prompt away.  Only cold streams are
        candidates — anything with an in-flight or queued request keeps
        its device residency.  Returns True if any blocks were freed."""
        if self.swap is None:
            return False
        alloc = self.engine.allocator
        busy = {r.slot for r in list(self.active_verify) + list(self.verify_q)}
        freed_any = False
        while deficit > 0:
            holders = [s for s in range(self.engine.max_slots)
                       if alloc.n_blocks_of[s] > 0]
            if len(holders) <= 1:
                break
            oldest = min(holders, key=lambda s: self.slot_age[s])
            cands = [s for s in holders
                     if s != oldest and s not in busy
                     and not self._slot_swapped(s)
                     and self._swap_possible(s)]
            if not cands:
                break
            victim = pick_victim(self.preempt_policy, cands, self)
            before = alloc.allocatable_blocks()
            t0 = self.clock.now_ms
            moved = self.swap.swap_out(victim, self.slot_prompt.get(victim),
                                       int(self.cloud_len[victim]))
            if moved is None:
                break
            self.swap_evictions += 1
            self.admission_swaps += 1
            self.clock.advance(self.latency.host_transfer_ms(moved))
            if self.tracer.enabled:
                self.tracer.span(t0, self.clock.now_ms, "swap_out",
                                 replica=self.replica, slot=victim,
                                 nbytes=moved)
                self.tracer.instant("admission_swap", replica=self.replica,
                                    slot=victim)
            deficit -= alloc.allocatable_blocks() - before
            freed_any = True
        return freed_any

    def _evict(self, slot: int, feeding, tokens, positions, targets,
               sel_idx, kept) -> bool:
        """Evict ``slot`` by the cheaper disposition: swap to the host
        tier when the modeled D2H+H2D round trip on its measured block
        bytes undercuts the modeled re-prefill of its accepted frontier
        (or when the stream cannot restart at all), recompute-eviction
        otherwise.  Returns True when blocks actually came back."""
        if self.swap is not None:
            p = self.swap.plan(slot)
            if p is not None:
                nbytes = p[2]
                frontier = int(self.cloud_len[slot])
                swap_ms = self.latency.swap_roundtrip_ms(nbytes)
                redo = frontier
                if alloc := getattr(self.engine, "allocator", None):
                    if alloc.retain_prefix:
                        # under retention a recompute restart re-matches
                        # its leading blocks (they park cached-free, not
                        # freed): the disposition compares against the
                        # cheaper, real refeed
                        prompt = self.slot_prompt.get(slot)
                        if prompt is not None:
                            redo -= (len(alloc.match_prefix(prompt))
                                     * alloc.block_size)
                redo_ms = self.latency.refeed_ms(max(0, redo), self.chunk)
                if swap_ms < redo_ms or not self._slot_restartable(slot):
                    t0 = self.clock.now_ms
                    moved = self.swap.swap_out(
                        slot, self.slot_prompt.get(slot), frontier)
                    if moved is not None:
                        self.swap_evictions += 1
                        self.clock.advance(
                            self.latency.host_transfer_ms(moved))
                        if self.tracer.enabled:
                            self.tracer.span(
                                t0, self.clock.now_ms, "swap_out",
                                replica=self.replica, slot=slot,
                                nbytes=moved)
                        for entry in feeding:
                            if entry[0].slot == slot:
                                self._withdraw(entry, feeding, tokens,
                                               positions, targets, sel_idx,
                                               kept)
                                break
                        return True
        if not self._slot_restartable(slot):
            return False               # cannot swap, cannot restart: defer
        self._preempt_slot(slot, feeding, tokens, positions, targets,
                           sel_idx, kept)
        return True

    def _swap_in_ready(self) -> None:
        """Restore swapped-out streams (FIFO over swap-out order) while
        the pool can take them — before admission, so returning streams
        are not starved by fresh prompts.  A stream whose shared lead
        expired from the prefix index while it was on the host (its
        sibling died) degrades to recompute-eviction: the host payload
        alone cannot rebuild the missing prefix KV."""
        if self.swap is None:
            return
        alloc = self.engine.allocator
        for slot in self.swap.swapped_slots:
            if self.swap.blocks_needed(slot) > alloc.allocatable_blocks():
                break                  # FIFO: no bypass (anti-starvation)
            res = self.swap.swap_in(slot)
            if res is None:
                self.swap_expirations += 1
                if self.tracer.enabled:
                    self.tracer.instant("swap_expire",
                                        replica=self.replica, slot=slot)
                self._rewind_slot(slot)
                continue
            frontier, nbytes = res
            self.cloud_len[slot] = frontier
            t0 = self.clock.now_ms
            self.clock.advance(self.latency.host_transfer_ms(nbytes))
            if self.tracer.enabled:
                self.tracer.span(t0, self.clock.now_ms, "swap_in",
                                 replica=self.replica, slot=slot,
                                 nbytes=nbytes)

    def _rewind_slot(self, slot: int) -> None:
        """Recompute-eviction bookkeeping: cloud frontier rewinds and
        pending requests refeed (re-derived from ``req.seq`` — the
        from-scratch partial prefill).  With prefix retention (or a live
        sibling) the restart first re-adopts whatever leading blocks the
        index still holds, so the refeed starts at the first unmatched
        token instead of zero."""
        self.last_row.pop(slot, None)
        reqs = [r for r in list(self.active_verify) + list(self.verify_q)
                if r.slot == slot]
        if self.tracer.enabled:
            # the rewind instant marks every serving span of these
            # requests before this point as wasted work ("preempted"
            # bucket in the stall attribution)
            self.tracer.instant("rewind", replica=self.replica, slot=slot,
                                rids=tuple(r.req_id for r in reqs))
        shared = 0
        if reqs and reqs[0].seq is not None:
            # the earliest request's seq is a prefix of every later one;
            # matching caps at len-1 so at least one token always feeds
            shared = self.engine.readopt_prefix(
                slot, np.asarray(reqs[0].seq)) \
                if hasattr(self.engine, "readopt_prefix") else 0
        self.cloud_len[slot] = shared
        for r in reqs:
            self.preempted_refed_tokens += max(
                0, r.start_pos + r.fed - shared)
            r.fed = 0
            r.rows = []
            r.start_pos = shared
            r.uncached = np.asarray(r.seq, np.int64)[shared:]

    def _preempt_slot(self, slot: int, feeding, tokens, positions,
                      targets, sel_idx, kept) -> None:
        """Recompute-evict ``slot``: blocks back to the pool, cloud
        frontier to 0, pending requests rewound to refeed from scratch;
        if the slot was in the current batch, its chunk is withdrawn."""
        if self.tracer.enabled:
            self.tracer.instant("preempt", replica=self.replica, slot=slot)
        self.engine.reset_slot(slot)            # frees + invalidates blocks
        self._rewind_slot(slot)
        for entry in feeding:
            if entry[0].slot == slot:
                self._withdraw(entry, feeding, tokens, positions, targets,
                               sel_idx, kept)
                break
        self.recompute_evictions += 1

    def _finish_verify(self, req: VerifyRequest) -> SchedulerEvent:
        gamma = len(req.draft)
        # rows for positions draft_start-1 .. draft_start+gamma-1
        need = gamma + 1
        rows = sorted(req.rows, key=lambda x: x[0])[-need:]
        if len(rows) < need:
            # Only a 1-row shortfall is legitimate: the first
            # verification right after prefill feeds no uncached token,
            # so the row preceding the draft is the prefill's last row
            # (retained per slot).  Anything else is a bookkeeping bug —
            # fail loudly instead of silently mis-aligning rows.
            if len(rows) != need - 1:
                raise RuntimeError(
                    f"verify req {req.req_id} (slot {req.slot}) retained "
                    f"{len(rows)} rows but needs {need}: drafts must be "
                    f"fed in full before verification")
            if req.slot not in self.last_row:
                raise RuntimeError(
                    f"verify req {req.req_id} needs the prefill row for "
                    f"slot {req.slot}, but no prefill was recorded")
            pre = self.last_row[req.slot]
            if self.fused:
                # the prefill row's target (draft[0]) is only known now;
                # mirror the device epilogue on the retained full row
                pre = V.fused_row_from_logits(pre, int(req.draft[0]),
                                              self.engine.verify_top_k)
            rows = [(-1, pre)] + rows
        if self.fused:
            ids = np.array([r[1][0] for r in rows])
            if req.sampling == "greedy":
                res = V.verify_greedy_ids(req.draft, ids)
            else:
                p_draft = np.array([rows[t][1][1] for t in range(gamma)])
                topk = [(rows[t][1][2], rows[t][1][3])
                        for t in range(need)]
                res = V.verify_sample_fused(req.draft, p_draft, topk,
                                            req.q_sparse, self.rng,
                                            self.engine.vocab)
        else:
            p_logits = np.stack([r[1] for r in rows])  # (gamma+1, V)
            if req.sampling == "greedy":
                res = V.verify_greedy(req.draft, p_logits)
            else:
                res = V.verify_sample(req.draft, p_logits, req.q_sparse,
                                      self.rng)
        # roll the cloud cache frontier back to the accepted prefix: the
        # rejected draft tokens were written to cache but their positions
        # will be overwritten by the corrected continuation (cache_write
        # is idempotent per position).
        accepted_abs = (req.start_pos + len(req.uncached) + res.n_accepted)
        self.cloud_len[req.slot] = accepted_abs
        self._first_emit.add(req.slot)   # TTFT budget met: deadline governs
        return SchedulerEvent("verify_done", req.req_id, req.slot, result=res)

    # -- plain decode (cloud-centric baseline) ---------------------------
    def decode_iteration(self, tokens: np.ndarray, positions: np.ndarray):
        """tokens/positions: (max_slots, 1); position -1 = idle slot.
        Returns the engine's fused DecodeRows (argmax + top-k support)."""
        t0 = self.clock.now_ms
        b0 = getattr(self.engine, "bytes_to_host", 0)
        rows = self.engine.decode(tokens, positions)
        moved = getattr(self.engine, "bytes_to_host", 0) - b0
        active = int((positions >= 0).sum())
        self.clock.advance(self.latency.iteration_ms(active)
                           + self.latency.host_transfer_ms(moved))
        if self.tracer.enabled:
            self.tracer.span(t0, self.clock.now_ms, "decode",
                             replica=self.replica, tokens=active,
                             nbytes=moved)
        return rows
