"""Unified tracing layer: lifecycle spans, stall attribution, Perfetto.

Every serving component that acts (device coroutine, scheduler, cloud
engine, swap tier, block allocator, router) stamps structured events
through one shared :class:`Tracer` bound to the run's clock —
``SimClock`` and ``RealClock`` expose the same ``now_ms`` axis
(serving/link.py), so the recording code is identical under
discrete-event simulation and wall-clock serving; the gateway only
reads the tracer (``/v1/traces``, ``/metrics``).  Four artifacts come
out of the same event stream:

* **Charge spans** — every modeled cost the scheduler charges to the
  shared clock (prefill / verify / decode iterations, swap D2H/H2D
  transfers, exit-time demotions, idle fast-forwards) becomes a typed
  span tagged with the replica, the request ids it served, the slot it
  touched, and the token/byte volume.  Recorded in time order, they are
  what stall attribution bisects.

* **Program spans** — where the serving path's own time goes, nested
  inside the charge spans and recorded beside them (``cat: "program"``
  in the export):

  ===================  ==============================================
  ``sched.iteration``  one ``run_iteration`` call that ran a batch
                       (scheduler.py); args ``kind`` (prefill /
                       verify), ``slots`` packed; ``rids`` and
                       ``tokens`` fed; no parent
  ``engine.forward``   one fused sub-chunk of ``CloudEngine.feed`` /
                       ``.prefill`` (engine.py): padding, the
                       host-to-card copies and the step's launches,
                       the cache-write index's host sync included;
                       args ``entry`` (feed / prefill), ``bucket``
                       width, ``rows_run`` (slots x bucket),
                       ``rows_real`` (positions >= 0)
  ``engine.to_host``   one blocking read of a sub-chunk's rows to the
                       host (the wait on the card, and ``prefill``'s
                       last-row gather); ``nbytes`` moved
  ===================  ==============================================

  Each ``engine.*`` span carries its iteration's ``rids`` and names the
  enclosing ``sched.iteration`` as ``parent`` (the index
  :meth:`Tracer.span` returned for it).  They are kept in a list of
  their own, apart from the charge spans, so :meth:`Tracer.window_parts`
  and hence the stall buckets never see them: they overlap the charge
  spans of the same iteration, and counting them too would count one
  stretch of wall time twice, so a window's parts would no longer sum
  to the window and the buckets would lean to the first parts.  The
  list has its own ``max_records`` cap, so program spans never crowd
  out the charge spans that attribution bisects.  They are opt-in:
  ``VerificationAwareScheduler.set_tracer(tracer, program=True)``
  records them, a tracer given to the scheduler's constructor (the
  gateway's, ``run_synera``'s) does not.

* **Per-stream async spans** — each stream is an async track (queued →
  slot assignment → device draft / PI overlap / stall windows → each
  verify round trip → emits → done), anchored at ``session.start_ms``
  on the shared clock.

* **Stall attribution** — every stream's end-to-end time decomposes
  into *exclusive* buckets that sum to its wall time:

  ===========  ======================================================
  device       on-device SLM compute (draft, prefill, PI overlap)
  cloud        verify/prefill iterations that actually fed this stream
  link         WAN uplink/downlink transfer (unmasked portion)
  queue        admission queueing before the stream's prompt prefill
               executed (no slot / no blocks)
  batch_wait   shared-clock time spent behind *other* streams' work
               while this stream's request was in flight
  swap         host-swap D2H/H2D transfers charged to this stream's
               slot
  preempted    serving work that was later thrown away by a
               recompute-eviction rewind of this stream's request
  other        unattributed residue: stalls recorded while tracing is
               off, plus (under ``RealClock`` without pacing) host
               compute the latency model does not cover
  ===========  ======================================================

  The decomposition walks the round trip in time order — uplink, then
  the scheduler's charge spans inside the request's in-flight window
  ``[arrival, completion]``, then downlink — and drops the leading
  ``overlap_ms`` hidden by stall-free parallel inference (the PI
  overlap masks the *front* of the round trip; the stall is its tail).
  ``StreamTimeline.bucket_sum == t_ms`` holds exactly by construction.

Tracing must never change behavior: recording is strictly passive (no
clock advances, no RNG draws, no read of a device tensor), so token
streams are byte-identical with tracing on or off.  When disabled, the
module-level :data:`NULL_TRACER` is installed everywhere and every
hot-path call site guards on ``tracer.enabled`` — the disabled path
allocates nothing.  ``VerificationAwareScheduler.set_tracer`` attaches
or detaches a tracer on a running scheduler, the engine's block
allocator and its swap manager at once, and with ``program=True`` on
the engine too.

Clock: a tracer takes an anchor pair (``clock.now_ms``,
``time.time_ns()``) when it is made.  ``torch.profiler``'s Chrome export
stamps ``ts`` as ``time.time_ns() / 1e3`` less the file's
``baseTimeNanoseconds / 1e3``, so :meth:`Tracer.profiler_offset_us`
turns the anchor into the offset that :meth:`Tracer.to_events` adds to
land every span of a ``RealClock`` run on a device trace's timebase.

Export is Chrome trace-event JSON (``{"traceEvents": [...]}``) loadable
in ``ui.perfetto.dev``: one process per replica with an engine track
plus one track per touched slot, and a ``streams`` process carrying the
per-stream async spans.  docs/observability.md describes the schema
(written for the reference's ``repro.launch.serve``; the port's
launcher is ``python -m repro_torch.launch.serve``, with the same
flags).
"""
from __future__ import annotations

import json
import time
from bisect import bisect_left
from dataclasses import dataclass

# engine-side span kinds whose cost is a host-swap transfer for a slot
_SWAP_KINDS = ("swap_out", "swap_in", "swap_demote")
# program spans: nested inside the charge spans, skipped by window_parts
PROGRAM_KINDS = ("sched.iteration", "engine.forward", "engine.to_host")

# fixed Prometheus histogram ladder for TTFT/TPOT/E2E (milliseconds)
HIST_BUCKETS_MS = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


# ---------------------------------------------------------------------------
# Prometheus histogram helpers (gateway /metrics; serving/gateway/protocol)
# ---------------------------------------------------------------------------

def hist_new() -> dict:
    """Empty cumulative histogram over :data:`HIST_BUCKETS_MS`.

    ``buckets[i]`` counts samples ``<= le[i]`` (Prometheus cumulative
    semantics); the trailing entry is the ``+Inf`` bucket (== count)."""
    return {"le": list(HIST_BUCKETS_MS),
            "buckets": [0] * (len(HIST_BUCKETS_MS) + 1),
            "sum": 0.0, "count": 0}


def hist_add(h: dict, v: float) -> None:
    for i, le in enumerate(h["le"]):
        if v <= le:
            h["buckets"][i] += 1
    h["buckets"][-1] += 1
    h["sum"] += float(v)
    h["count"] += 1


def hist_from(samples) -> dict:
    h = hist_new()
    for v in samples:
        hist_add(h, float(v))
    return h


def hist_merge(hists) -> dict:
    """Fold cumulative histograms (identical ladders) into one."""
    out = hist_new()
    for h in hists:
        for i, c in enumerate(h["buckets"]):
            out["buckets"][i] += c
        out["sum"] += h["sum"]
        out["count"] += h["count"]
    return out


# ---------------------------------------------------------------------------
# Per-stream timeline
# ---------------------------------------------------------------------------

@dataclass
class StreamTimeline:
    """Simulated wall-clock of one request stream, decomposed into the
    exclusive stall buckets above.  Every path that advances ``t_ms``
    credits exactly one bucket, so ``bucket_sum == t_ms`` always holds
    — with tracing off the stall portion simply lands in ``other_ms``.

    ``comm_ms`` keeps its legacy meaning: communication time, including
    round-trip time *masked* by PI overlap (which does not advance
    ``t_ms`` and therefore is not a bucket)."""
    t_ms: float = 0.0
    stall_ms: float = 0.0
    compute_ms: float = 0.0        # == the "device" bucket
    comm_ms: float = 0.0
    energy_j: float = 0.0
    # -- exclusive stall buckets (device bucket is compute_ms) --
    cloud_ms: float = 0.0
    link_ms: float = 0.0
    queue_ms: float = 0.0
    batch_wait_ms: float = 0.0
    swap_ms: float = 0.0
    preempted_ms: float = 0.0
    other_ms: float = 0.0

    _CAT = {"cloud": "cloud_ms", "link": "link_ms", "queue": "queue_ms",
            "wait": "batch_wait_ms", "swap": "swap_ms",
            "preempted": "preempted_ms", "other": "other_ms"}

    def advance(self, dt: float, kind: str):
        self.t_ms += dt
        if kind == "stall":
            self.stall_ms += dt
            self.other_ms += dt    # unattributed (blocking path / no trace)
        elif kind == "compute":
            self.compute_ms += dt
        elif kind == "comm":
            self.comm_ms += dt
            self.link_ms += dt

    def advance_stall(self, stall_ms: float, up_ms: float, cloud_parts,
                      down_ms: float, overlap_ms: float) -> None:
        """Advance by one verify round trip's pipeline stall and
        attribute it.  ``cloud_parts`` is ``Tracer.window_parts`` for
        the request's in-flight window (``None`` when tracing is off:
        the whole stall lands in ``other``).  The round trip in time
        order is uplink → cloud window → downlink; the leading
        ``overlap_ms`` was masked by PI compute (already counted as
        device time), so it is dropped from the front and only the tail
        is attributed.  Buckets gain exactly ``stall_ms`` total."""
        self.t_ms += stall_ms
        self.stall_ms += stall_ms
        if stall_ms <= 0.0:
            return
        if cloud_parts is None:
            self.other_ms += stall_ms
            return
        rem = overlap_ms
        categorized = 0.0
        for cat, dur in ([("link", up_ms)] + list(cloud_parts)
                         + [("link", down_ms)]):
            if dur <= 0.0:
                continue
            hide = min(rem, dur)
            rem -= hide
            keep = min(dur - hide, stall_ms - categorized)
            if keep > 0.0:
                f = self._CAT[cat]
                setattr(self, f, getattr(self, f) + keep)
                categorized += keep
        # float residue (and any uncovered window time) stays exclusive
        self.other_ms += stall_ms - categorized

    def buckets(self) -> dict:
        return {"device": self.compute_ms, "cloud": self.cloud_ms,
                "link": self.link_ms, "queue": self.queue_ms,
                "batch_wait": self.batch_wait_ms, "swap": self.swap_ms,
                "preempted": self.preempted_ms, "other": self.other_ms}

    @property
    def bucket_sum(self) -> float:
        return (self.compute_ms + self.cloud_ms + self.link_ms
                + self.queue_ms + self.batch_wait_ms + self.swap_ms
                + self.preempted_ms + self.other_ms)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

class _NullTracer:
    """Disabled tracer: every method is a no-op and ``enabled`` is
    False, so hot paths guard with one attribute read and never build
    event payloads — zero allocation on the disabled path."""
    enabled = False
    clock = None

    def __bool__(self):
        return False

    def span(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass

    def stream_begin(self, *a, **k):
        return -1

    def stream_child(self, *a, **k):
        pass

    def stream_instant(self, *a, **k):
        pass

    def stream_end(self, *a, **k):
        pass

    def window_parts(self, *a, **k):
        return None

    def to_events(self):
        return []

    def export(self, path):
        raise RuntimeError("tracing is disabled (NULL_TRACER)")


NULL_TRACER = _NullTracer()


class _StreamRec:
    __slots__ = ("uid", "name", "t0", "t1", "replica", "meta",
                 "children", "instants", "end_meta")

    def __init__(self, uid, name, t0, replica, meta):
        self.uid = uid
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.replica = replica
        self.meta = meta or {}
        self.children = []        # (name, t0, t1)
        self.instants = []        # (name, t, n)
        self.end_meta = None


class Tracer:
    """Records spans/instants stamped on the shared clock.

    One tracer serves a whole fleet: replicas tag their events with
    their index, and with one shared clock (and one engine thread in
    the gateway) the charge spans are globally chronological — which is
    what lets :meth:`window_parts` decompose any request's in-flight
    window by bisection.  ``max_records`` bounds memory on long
    gateway runs: past the cap new charge spans, program spans or
    instants (each kind of record capped apart) are counted but dropped
    (attribution then falls back to the ``other`` bucket for windows it
    can no longer cover)."""

    def __init__(self, clock, *, max_records: int = 1 << 20):
        self.clock = clock
        self.enabled = True
        self.max_records = max_records
        self.dropped = 0
        # (clock.now_ms, time.time_ns()): places the spans of a
        # RealClock run on a device trace's timebase (profiler_offset_us)
        self.anchor = (clock.now_ms, time.time_ns())
        self._spans = []          # (t0,t1,kind,replica,rids,slot,tokens,nbytes)
        self._span_t0s = []       # parallel array for bisect
        # program spans, capped apart: (t0,t1,kind,replica,rids,tokens,
        # nbytes,parent,args)
        self._program = []
        self._instants = []       # (t, kind, replica, slot, rids, n)
        self._rewinds = []        # (t, replica, rids) — preemption rewinds
        self._streams: dict[int, _StreamRec] = {}
        self._uid = 0

    # -- engine-side recording -----------------------------------------
    def span(self, t0: float, t1: float, kind: str, replica: int = 0,
             rids=(), slot: int = -1, tokens: int = 0,
             nbytes: int = 0, parent: int = -1,
             args: dict | None = None) -> int:
        """Record one span.  A program span (:data:`PROGRAM_KINDS`) goes
        to a list of its own and returns its index, which its children
        name as ``parent`` (-1 when it was dropped past
        ``max_records``); a charge span returns -1."""
        if kind in PROGRAM_KINDS:
            if len(self._program) >= self.max_records:
                self.dropped += 1
                return -1
            self._program.append((t0, t1, kind, replica, rids, tokens,
                                  nbytes, parent, args))
            return len(self._program) - 1
        if len(self._spans) >= self.max_records:
            self.dropped += 1
            return -1
        self._spans.append((t0, t1, kind, replica, rids, slot, tokens,
                            nbytes))
        self._span_t0s.append(t0)
        return -1

    def span_end(self, idx: int, t1: float) -> None:
        """Close program span ``idx``, recorded open (``t1 == t0``) so
        that its children could name it as their parent before it
        ended."""
        if idx >= 0:
            self._program[idx] = (self._program[idx][0], t1) + \
                self._program[idx][2:]

    def instant(self, kind: str, t: float | None = None, replica: int = 0,
                slot: int = -1, rids=(), n: int = 0) -> None:
        if t is None:
            t = self.clock.now_ms
        if kind == "rewind":
            self._rewinds.append((t, replica, rids))
        if len(self._instants) >= self.max_records:
            self.dropped += 1
            return
        self._instants.append((t, kind, replica, slot, rids, n))

    # -- per-stream lifecycle ------------------------------------------
    def stream_begin(self, name: str, t: float, *, replica: int = 0,
                     meta: dict | None = None) -> int:
        self._uid += 1
        self._streams[self._uid] = _StreamRec(self._uid, name, t, replica,
                                              meta)
        return self._uid

    def stream_child(self, uid: int, name: str, t0: float,
                     t1: float) -> None:
        rec = self._streams.get(uid)
        if rec is not None:
            rec.children.append((name, t0, t1))

    def stream_instant(self, uid: int, name: str, t: float,
                       n: int = 0) -> None:
        rec = self._streams.get(uid)
        if rec is not None:
            rec.instants.append((name, t, n))

    def stream_end(self, uid: int, t: float, *,
                   meta: dict | None = None) -> None:
        rec = self._streams.get(uid)
        if rec is not None:
            rec.t1 = t
            rec.end_meta = meta or {}

    # -- stall attribution ---------------------------------------------
    def window_parts(self, a: float, c: float, *, replica: int = 0,
                     slot: int = -1, vrid: int = -1,
                     prefill_rid: int | None = None) -> list:
        """Decompose the in-flight window ``[a, c]`` of one verify
        request into chronological ``(category, ms)`` parts.

        Charge spans inside the window classify as:

        * ``cloud`` — iterations that fed this request (``vrid``) or
          executed this stream's prompt prefill (``prefill_rid``);
        * ``preempted`` — such serving spans that a later
          recompute-eviction rewind of this request threw away;
        * ``swap`` — host-swap transfers charged to this stream's slot;
        * ``queue`` — non-serving time before the stream's prompt
          prefill executed (admission queueing: no slot / no blocks);
        * ``wait`` — every other charge in the window (other streams'
          iterations, scheduler overhead, idle fast-forwards);
        * ``other`` — window time no recorded span covers (zero under
          ``SimClock``; real host compute under ``RealClock``).

        The parts sum exactly to ``c - a``.  Purely read-only."""
        if c <= a:
            return []
        spans = self._spans
        lo = bisect_left(self._span_t0s, a)
        if lo > 0:
            lo -= 1                # the span straddling ``a``
        rw = 0.0                   # latest rewind of vrid inside the window
        for t, rep, rids in self._rewinds:
            if a <= t <= c and rep == replica and vrid in rids:
                rw = max(rw, t)
        boundary = None            # start of this stream's prompt prefill
        raw = []                   # [cat, clipped_dur, span_t1]
        covered = 0.0
        for i in range(lo, len(spans)):
            t0, t1, kind, rep, rids, sslot, _, _ = spans[i]
            if t0 >= c:
                break
            d = min(t1, c) - max(t0, a)
            if d <= 0.0:
                continue
            serving = (rep == replica
                       and (vrid in rids
                            or (prefill_rid is not None
                                and prefill_rid in rids)))
            if serving:
                if (boundary is None and kind == "prefill"
                        and prefill_rid is not None
                        and prefill_rid in rids):
                    boundary = t0
                cat = "preempted" if t1 <= rw else "cloud"
            elif (kind in _SWAP_KINDS and rep == replica
                  and sslot == slot):
                cat = "swap"
            else:
                cat = "wait"
            raw.append([cat, d, t1])
            covered += d
        if boundary is not None:
            # charges that finished before our prompt prefill began are
            # admission queueing, not batch wait: the stream had no slot
            for p in raw:
                if p[0] == "wait" and p[2] <= boundary:
                    p[0] = "queue"
        out = []
        for cat, d, _ in raw:
            if out and out[-1][0] == cat:
                out[-1] = (cat, out[-1][1] + d)
            else:
                out.append((cat, d))
        resid = (c - a) - covered
        if resid > 1e-9:
            out.append(("other", resid))
        return out

    # -- export ---------------------------------------------------------
    @staticmethod
    def _us(t_ms: float) -> float:
        return t_ms * 1000.0

    def profiler_offset_us(self, base_ns: int) -> float:
        """What :meth:`to_events` adds to put this tracer's spans on the
        timebase of a ``torch.profiler`` Chrome trace whose
        ``baseTimeNanoseconds`` is ``base_ns``.  Meaningful for a
        ``RealClock`` (a ``SimClock`` is not wall time)."""
        t_ms, t_ns = self.anchor
        return (t_ns - base_ns) / 1e3 - t_ms * 1e3

    def to_events(self, offset_us: float = 0.0) -> list[dict]:
        """Chrome trace-event list: pid 0 carries the per-stream async
        spans; pid ``1 + replica`` carries that replica's engine track
        (tid 0) and one track per touched slot (tid ``1 + slot``).
        Every ``ts`` is the clock's milliseconds in microseconds, plus
        ``offset_us``."""
        def us(t_ms):
            return self._us(t_ms) + offset_us

        ev = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "streams"}}]
        replicas, slots = set(), set()
        for t0, t1, kind, rep, rids, slot, tokens, nbytes in self._spans:
            replicas.add(rep)
            tid = 1 + slot if (slot >= 0 and kind in _SWAP_KINDS) else 0
            if tid > 0:
                slots.add((rep, slot))
            args = {}
            if rids:
                args["rids"] = [int(r) for r in rids]
            if slot >= 0:
                args["slot"] = slot
            if tokens:
                args["tokens"] = int(tokens)
            if nbytes:
                args["nbytes"] = int(nbytes)
            ev.append({"ph": "X", "name": kind, "cat": "engine",
                       "ts": us(t0),
                       "dur": max(self._us(t1 - t0), 0.0),
                       "pid": 1 + rep, "tid": tid, "args": args})
        for i, (t0, t1, kind, rep, rids, tokens, nbytes, parent,
                extra) in enumerate(self._program):
            replicas.add(rep)
            args = {"id": i}           # what a child's ``parent`` names
            if rids:
                args["rids"] = [int(r) for r in rids]
            if tokens:
                args["tokens"] = int(tokens)
            if nbytes:
                args["nbytes"] = int(nbytes)
            if parent >= 0:
                args["parent"] = parent
            if extra:
                args.update(extra)
            ev.append({"ph": "X", "name": kind, "cat": "program",
                       "ts": us(t0),
                       "dur": max(self._us(t1 - t0), 0.0),
                       "pid": 1 + rep, "tid": 0, "args": args})
        for t, kind, rep, slot, rids, n in self._instants:
            replicas.add(rep)
            tid = 1 + slot if slot >= 0 else 0
            if tid > 0:
                slots.add((rep, slot))
            args = {}
            if rids:
                args["rids"] = [int(r) for r in rids]
            if n:
                args["n"] = int(n)
            ev.append({"ph": "i", "s": "t", "name": kind, "cat": "engine",
                       "ts": us(t), "pid": 1 + rep, "tid": tid,
                       "args": args})
        for rec in self._streams.values():
            sid = str(rec.uid)
            name = f"{rec.name}-{rec.uid}"
            ev.append({"ph": "b", "name": name, "cat": "stream", "id": sid,
                       "ts": us(rec.t0), "pid": 0, "tid": 0,
                       "args": dict(rec.meta)})
            for cname, t0, t1 in rec.children:
                ev.append({"ph": "b", "name": cname, "cat": "stream",
                           "id": sid, "ts": us(t0), "pid": 0,
                           "tid": 0, "args": {}})
                ev.append({"ph": "e", "name": cname, "cat": "stream",
                           "id": sid, "ts": us(max(t1, t0)),
                           "pid": 0, "tid": 0, "args": {}})
            for iname, t, n in rec.instants:
                ev.append({"ph": "n", "name": iname, "cat": "stream",
                           "id": sid, "ts": us(t), "pid": 0,
                           "tid": 0, "args": ({"n": int(n)} if n else {})})
            t_end = rec.t1 if rec.t1 is not None else rec.t0
            ev.append({"ph": "e", "name": name, "cat": "stream", "id": sid,
                       "ts": us(max(t_end, rec.t0)), "pid": 0,
                       "tid": 0, "args": dict(rec.end_meta or {})})
        for rep in sorted(replicas):
            ev.append({"ph": "M", "name": "process_name", "pid": 1 + rep,
                       "tid": 0, "args": {"name": f"replica-{rep}"}})
            ev.append({"ph": "M", "name": "thread_name", "pid": 1 + rep,
                       "tid": 0, "args": {"name": "engine"}})
        for rep, slot in sorted(slots):
            ev.append({"ph": "M", "name": "thread_name", "pid": 1 + rep,
                       "tid": 1 + slot, "args": {"name": f"slot-{slot}"}})
        return ev

    def to_dict(self) -> dict:
        return {"traceEvents": self.to_events(), "displayTimeUnit": "ms",
                "synera": {"spans": len(self._spans),
                           "instants": len(self._instants),
                           "streams": len(self._streams),
                           "dropped": self.dropped}}

    def export(self, path: str) -> str:
        """Write the Perfetto/Chrome trace-event JSON file."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path
