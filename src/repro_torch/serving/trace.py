"""Unified tracing layer: lifecycle spans, stall attribution, Perfetto.

Every serving component (device coroutine, scheduler, swap tier, block
allocator, router, gateway) stamps structured events through one shared
:class:`Tracer` bound to the run's clock — ``SimClock`` and
``RealClock`` expose the same ``now_ms`` axis (serving/link.py), so the
recording code is identical under discrete-event simulation and
wall-clock serving.  Three artifacts come out of the same event stream:

* **Engine-side spans** — every modeled cost the scheduler charges to
  the shared clock (prefill / verify / decode iterations, swap D2H/H2D
  transfers, exit-time demotions, idle fast-forwards) becomes a typed
  span tagged with the replica, the request ids it served, the slot it
  touched, and the token/byte volume.  These replace the vestigial
  ``Timeline.events`` ``(kind, dt)`` tuples that used to pile up per
  stream: the charge stream now lives once, globally, typed.

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
clock advances, no RNG draws), so token streams are byte-identical with
tracing on or off.  When disabled, the module-level :data:`NULL_TRACER`
is installed everywhere and every hot-path call site guards on
``tracer.enabled`` — the disabled path allocates nothing.

Export is Chrome trace-event JSON (``{"traceEvents": [...]}``) loadable
in ``ui.perfetto.dev``: one process per replica with an engine track
plus one track per touched slot, and a ``streams`` process carrying the
per-stream async spans.  See docs/observability.md.
"""
from __future__ import annotations

import json
from bisect import bisect_left
from dataclasses import dataclass

# engine-side span kinds whose cost is a host-swap transfer for a slot
_SWAP_KINDS = ("swap_out", "swap_in", "swap_demote")

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
# Per-stream timeline (absorbs the old serving/link.py Timeline)
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
    the gateway) the charge stream is globally chronological — which is
    what lets :meth:`window_parts` decompose any request's in-flight
    window by bisection.  ``max_records`` bounds memory on long
    gateway runs: past the cap new engine spans/instants are counted
    but dropped (attribution then falls back to the ``other`` bucket
    for windows it can no longer cover)."""

    def __init__(self, clock, *, max_records: int = 1 << 20):
        self.clock = clock
        self.enabled = True
        self.max_records = max_records
        self.dropped = 0
        self._spans = []          # (t0,t1,kind,replica,rids,slot,tokens,nbytes)
        self._span_t0s = []       # parallel array for bisect
        self._instants = []       # (t, kind, replica, slot, rids, n)
        self._rewinds = []        # (t, replica, rids) — preemption rewinds
        self._streams: dict[int, _StreamRec] = {}
        self._uid = 0

    # -- engine-side recording -----------------------------------------
    def span(self, t0: float, t1: float, kind: str, replica: int = 0,
             rids=(), slot: int = -1, tokens: int = 0,
             nbytes: int = 0) -> None:
        if len(self._spans) >= self.max_records:
            self.dropped += 1
            return
        self._spans.append((t0, t1, kind, replica, rids, slot, tokens,
                            nbytes))
        self._span_t0s.append(t0)

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

    def to_events(self) -> list[dict]:
        """Chrome trace-event list: pid 0 carries the per-stream async
        spans; pid ``1 + replica`` carries that replica's engine track
        (tid 0) and one track per touched slot (tid ``1 + slot``)."""
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
                       "ts": self._us(t0),
                       "dur": max(self._us(t1 - t0), 0.0),
                       "pid": 1 + rep, "tid": tid, "args": args})
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
                       "ts": self._us(t), "pid": 1 + rep, "tid": tid,
                       "args": args})
        for rec in self._streams.values():
            sid = str(rec.uid)
            name = f"{rec.name}-{rec.uid}"
            ev.append({"ph": "b", "name": name, "cat": "stream", "id": sid,
                       "ts": self._us(rec.t0), "pid": 0, "tid": 0,
                       "args": dict(rec.meta)})
            for cname, t0, t1 in rec.children:
                ev.append({"ph": "b", "name": cname, "cat": "stream",
                           "id": sid, "ts": self._us(t0), "pid": 0,
                           "tid": 0, "args": {}})
                ev.append({"ph": "e", "name": cname, "cat": "stream",
                           "id": sid, "ts": self._us(max(t1, t0)),
                           "pid": 0, "tid": 0, "args": {}})
            for iname, t, n in rec.instants:
                ev.append({"ph": "n", "name": iname, "cat": "stream",
                           "id": sid, "ts": self._us(t), "pid": 0,
                           "tid": 0, "args": ({"n": int(n)} if n else {})})
            t_end = rec.t1 if rec.t1 is not None else rec.t0
            ev.append({"ph": "e", "name": name, "cat": "stream", "id": sid,
                       "ts": self._us(max(t_end, rec.t0)), "pid": 0,
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
