"""The program's own spans and counters over a traced stretch of one
benchmark cell, placed on the device trace's clock.

``bench_harness.traced_stretch`` times the cloud verifier from outside:
its annotations, ``CallRecorder``'s rebinding of two functions of
``models/layers.py``, and the scheduler's counters.  While
:func:`attached` is open, every traced stretch of
``bench_harness.run_cell`` also has the port's ``Tracer``
(``repro_torch/serving/trace.py``) on the scheduler with its program
spans (``VerificationAwareScheduler.set_tracer(tracer, program=True)``),
so the program records its own ``sched.iteration``, ``engine.forward``
and ``engine.to_host`` spans, and the engine's row counters are read
across the stretch; the spans are moved onto the profiler's timebase by
the tracer's anchor and the trace file's ``baseTimeNanoseconds``.  From
them :func:`readings` gives:

- ``idle_by_span``: each idle gap of the stretch goes to the innermost
  program span over its middle (an ``engine.*`` span ahead of its
  ``sched.iteration``), else to ``outside the program``;
- ``idle_in_forward_share`` %: the idle time inside ``engine.forward``
  over the stretch;
- ``idle_in_scheduler_share`` %: the idle time inside
  ``sched.iteration`` but outside every ``engine.*`` span, over the
  stretch;
- ``kernels_per_forward``: the stretch's kernel events over the
  engine's forwards in it;
- ``prefill_useful_row_share`` %: ``rows_real`` over ``rows_run`` of the
  ``prefill`` entry point across the stretch;
- ``launch_in_span_share`` %: of the stretch's kernel launches on the
  host, those inside an ``engine.*`` span (how well the clocks agree).

None of these is a metric of ``BENCHMARK.json`` yet: ``bench/run.py``'s
traced stretch would have to attach the tracer (PERF.md, Open
questions).  Run on the card, from the root of a checkout, with
``bench/run.py``'s arguments:

    python3 bench/bench_program.py --workload <cell> --seed <n> \\
        --seconds <s> --trace 1

It prints ``bench/run.py``'s result line, then one JSON line of the
readings above.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import sys
import time
from pathlib import Path

import bench_harness as H
import bench_trace

SPAN_KINDS = ("sched.iteration", "engine.forward", "engine.to_host")
ENGINE_KINDS = ("engine.forward", "engine.to_host")
OUTSIDE = "outside the program"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
ENTRIES = ("feed", "prefill")


# -- the trace file and the program's spans ---------------------------------

def merged_spans(doc: dict, tracer) -> list[dict]:
    """The tracer's program spans on the timebase of the profiler's
    Chrome trace ``doc``."""
    off = tracer.profiler_offset_us(int(doc.get("baseTimeNanoseconds", 0)))
    return [e for e in tracer.to_events(off)
            if e["ph"] == "X" and e["name"] in SPAN_KINDS]


def stretch_bounds(doc: dict):
    """(start, end) in µs of the ``bench.stretch`` annotation, or None."""
    for e in doc["traceEvents"]:
        if e.get("name") == bench_trace.STRETCH and \
                e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def idle_by_span(doc: dict, spans: list[dict], path: Path) -> dict | None:
    """Seconds of device idle time by the innermost program span over
    each gap's middle: ``bench_trace.summarize`` of a copy of ``doc``
    (written to ``path``) whose only host events are the stretch and
    the program spans.  None without a stretch or device events."""
    keep = [e for e in doc["traceEvents"]
            if e.get("cat") in bench_trace.DEVICE_CATS
            or (e.get("name") == bench_trace.STRETCH
                and e.get("cat") == "user_annotation")]
    keep += [dict(e, cat="user_annotation") for e in spans]
    Path(path).write_text(json.dumps({"traceEvents": keep}))
    summary = bench_trace.summarize(str(path))
    if summary is None:
        return None
    return {(OUTSIDE if k == "host (outside any op)" else k): v
            for k, v in summary.idle_by_host.items()}


class _Cover:
    """Disjoint spans of one thread, sorted: which one covers a time."""

    def __init__(self, spans):
        self.spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                            for e in spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i][2]
        return None


def launch_share(doc: dict, spans: list[dict]) -> tuple[int, int]:
    """(launches inside an ``engine.*`` span, all launches) among the
    stretch's kernel-launch runtime calls."""
    bounds = stretch_bounds(doc)
    if bounds is None:
        return 0, 0
    engine = _Cover([e for e in spans if e["name"] in ENGINE_KINDS])
    inside = total = 0
    for e in doc["traceEvents"]:
        if e.get("cat") == "cuda_runtime" and e.get("name") in LAUNCHES \
                and bounds[0] <= float(e["ts"]) <= bounds[1]:
            total += 1
            inside += engine.at(float(e["ts"])) is not None
    return inside, total


def kernel_count(doc: dict) -> int:
    """Kernel events that start inside the stretch."""
    bounds = stretch_bounds(doc)
    if bounds is None:
        return 0
    return sum(1 for e in doc["traceEvents"] if e.get("cat") == "kernel"
               and bounds[0] <= float(e["ts"]) <= bounds[1])


# -- the engine's counters --------------------------------------------------

def counters(eng) -> dict:
    """The engine's forwards and rows by entry point."""
    st = eng.compile_stats
    return {k: dict(st[k]) for k in ("forwards", "rows_run", "rows_real")}


def counter_delta(c0: dict, c1: dict) -> dict:
    return {k: {e: c1[k][e] - c0[k][e] for e in ENTRIES} for k in c1}


# -- the traced stretch -----------------------------------------------------

@contextlib.contextmanager
def attached():
    """While open, ``bench_harness.run_cell``'s traced stretch runs with
    a ``Tracer`` and its program spans on the scheduler, and detaches it
    after.  Yields a dict that the stretch fills: ``tracer``, ``counts``
    (the engine's counters across it), ``summary``, ``rows`` and
    ``calls`` (what the harness's stretch returned), ``iterations`` (the
    run's) and ``trace_path``."""
    from repro_torch.serving.trace import Tracer
    seen, inner = {}, H.traced_stretch

    def traced_stretch(run, seconds, trace_path):
        eng = run.sched.engine
        c0 = counters(eng)
        tracer = Tracer(run.clock)
        run.sched.set_tracer(tracer, program=True)
        try:
            summary, rows, calls = inner(run, seconds, trace_path)
        finally:
            run.sched.set_tracer(None)
        seen.update(tracer=tracer, counts=counter_delta(c0, counters(eng)),
                    summary=summary, rows=rows, calls=calls,
                    iterations=run.iterations, trace_path=Path(trace_path))
        return summary, rows, calls

    H.traced_stretch = traced_stretch
    try:
        yield seen
    finally:
        H.traced_stretch = inner


def readings(seen: dict) -> dict:
    """The quantities above from what :func:`attached` saw; a value is
    None where its source recorded nothing (on the CPU: no device
    events)."""
    path = seen["trace_path"]
    doc = json.loads(path.read_text())
    spans = merged_spans(doc, seen["tracer"])
    summary, counts = seen["summary"], seen["counts"]
    idle = idle_by_span(doc, spans, path.with_suffix(".program.json"))
    window = summary.window_s if summary is not None else 0.0
    forwards = sum(counts["forwards"].values())
    run_, real = counts["rows_run"]["prefill"], counts["rows_real"]["prefill"]
    inside, launches = launch_share(doc, spans)
    kernels = kernel_count(doc)
    return {
        "idle_in_forward_share": (100.0 * idle.get("engine.forward", 0.0)
                                  / window if idle else None),
        "idle_in_scheduler_share": (100.0 * idle.get("sched.iteration", 0.0)
                                    / window if idle else None),
        "kernels_per_forward": (kernels / forwards if kernels and forwards
                                else None),
        "prefill_useful_row_share": 100.0 * real / run_ if run_ else None,
        "launch_in_span_share": (100.0 * inside / launches if launches
                                 else None),
        "idle_by_span": idle,
        "idle_s": (summary.window_s - summary.busy_s
                   if summary is not None else None),
        "window_s": window or None,
        "kernels": kernels, "launches": launches, "forwards": forwards,
        "counts": counts,
        "spans": {k: sum(1 for e in spans if e["name"] == k)
                  for k in SPAN_KINDS},
    }


def main(argv) -> int:
    t_start = time.monotonic()
    with attached() as seen:
        rc = H.main(argv, root=H.BENCH.parent, t_start=t_start)
    if rc == 0 and seen:
        print(json.dumps({"program": readings(seen)}))
    return rc


if __name__ == "__main__":
    import os
    ROOT = Path(__file__).resolve().parents[1]
    # the kernel caches where bench/run.py puts them
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    sys.path[:0] = [str(ROOT / "src")]
    sys.exit(main(sys.argv[1:]))
