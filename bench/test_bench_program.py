"""The program's own sources against the harness's outside readings, on
the CPU: over one traced tiny run the engine's rows equal the rows that
``useful_row_share`` derives from ``CallRecorder``, each
``sched.iteration`` span lasts what the harness's own span around that
``run_iteration`` lasts, and the tracer is on for the stretch alone;
and ``idle_by_span`` and its neighbours on a Chrome trace written by
hand."""
import json

import pytest

import bench_program as P
import bench_tiny
import bench_trace
from repro_torch.serving.trace import Tracer


def _tiny(name, tmp_path, seed):
    with P.attached() as seen:
        res = bench_tiny.run(name, seed=seed, trace=True,
                             trace_path=tmp_path / "trace.json",
                             per_layer=[("useful_row_share", "%")])
    return dict(seen, result=res, program=P.readings(seen))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return _tiny("qwen1.5-7b", tmp_path_factory.mktemp("dense"), 2**31 + 5)


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    return _tiny("qwen3-moe-8l", tmp_path_factory.mktemp("moe"), 41)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_engine_rows_equal_the_call_recorders(name, request):
    st = request.getfixturevalue(name)
    cfg = bench_tiny.config("qwen1.5-7b" if name == "dense"
                            else "qwen3-moe-8l")
    layers = cfg["num_hidden_layers"]
    ran = sum(qs[0] * qs[1] for qs, _, _, _ in st["calls"]["partial_prefill"])
    assert ran > 0 and ran % layers == 0
    assert sum(st["counts"]["rows_run"].values()) == ran // layers
    assert sum(st["counts"]["forwards"].values()) == \
        len(st["calls"]["partial_prefill"]) // layers
    # the harness's share, and the same share from the program's counters
    share = st["result"]["metrics"]["useful_row_share"]["value"]
    assert share == pytest.approx(
        100.0 * st["rows"] / sum(st["counts"]["rows_run"].values()))
    # and the prefill share the program reads off its own counters
    r = st["program"]
    assert 0 < r["prefill_useful_row_share"] < 100
    assert r["spans"]["engine.forward"] == r["forwards"]


def test_iteration_spans_last_what_the_harness_saw(dense):
    spans = [e for e in dense["tracer"].to_events()
             if e["name"] == "sched.iteration"]
    assert spans
    lo, hi = spans[0]["ts"] / 1e3, (spans[-1]["ts"] + spans[-1]["dur"]) / 1e3
    its = [it for it in dense["iterations"]
           if lo - 1.0 <= it["start"] and it["end"] <= hi + 1.0]
    assert len(its) == len(spans)
    for it, sp in zip(its, spans):
        assert sp["args"]["kind"] == it["kind"]
        assert abs(sp["dur"] / 1e3 - (it["end"] - it["start"])) < 1.0
        assert it["start"] <= sp["ts"] / 1e3 + 1e-6


def test_tracer_is_on_for_the_stretch_alone(dense):
    """The run is correct, and its tracer saw the stretch's iterations
    and no others: the window's and the drain's ran untraced."""
    assert dense["result"]["correct"]
    spans = [e for e in dense["tracer"].to_events()
             if e["name"] == "sched.iteration"]
    its = dense["iterations"]
    assert 0 < len(spans) < len(its)
    first, last = spans[0]["ts"] / 1e3, spans[-1]["ts"] / 1e3
    assert any(it["start"] < first for it in its)
    assert any(it["start"] > last for it in its)
    assert bench_tiny.traffic()["trace_s"] * 1e3 >= last - first
    assert P.H.traced_stretch is not None and \
        P.H.traced_stretch.__module__ == "bench_harness"


class _Clock:
    now_ms = 0.0


BASE_NS = 1_790_000_000_000_000_000


def _doc(tmp_path):
    """A stretch of 1,000 µs on the profiler's timebase with three
    kernels, four launches and the program's spans of one iteration:
    the tracer's anchor puts its clock's 1,000 ms at 5,000 µs."""
    tracer = Tracer(_Clock())
    tracer.anchor = (1000.0, BASE_NS + 5_000_000)
    it = tracer.span(1000.04, 1000.04, "sched.iteration", rids=(1,))
    tracer.span(1000.06, 1000.32, "engine.forward", rids=(1,), parent=it)
    tracer.span(1000.32, 1000.5, "engine.to_host", rids=(1,), parent=it,
                nbytes=64)
    tracer.span_end(it, 1000.65)
    ev = [{"ph": "X", "cat": "user_annotation", "name": bench_trace.STRETCH,
           "ts": 5000.0, "dur": 1000.0, "pid": 1, "tid": 1}]
    for s in (100, 300, 700):
        ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": 5000.0 + s,
                   "dur": 100.0, "pid": 0, "tid": 7})
    for s in (70, 330, 600, 900):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": 5000.0 + s,
                   "dur": 5.0, "pid": 1, "tid": 1})
    path = tmp_path / "synthetic.json"
    path.write_text(json.dumps({"traceEvents": ev,
                                "baseTimeNanoseconds": BASE_NS}))
    return path, tracer


def test_idle_by_span_on_a_written_trace(tmp_path):
    """Gaps 0-100 (iteration), 200-300 (forward), 400-700 (middle 550:
    iteration, after the read), 800-1000 (outside): 400 + 100 + 200 µs,
    the stretch's 700 µs of idle time."""
    path, tracer = _doc(tmp_path)
    doc = json.loads(path.read_text())
    spans = P.merged_spans(doc, tracer)
    assert [(e["name"], round(e["ts"], 3), round(e["dur"], 3))
            for e in spans] == [("sched.iteration", 5040.0, 610.0),
                                ("engine.forward", 5060.0, 260.0),
                                ("engine.to_host", 5320.0, 180.0)]
    idle = P.idle_by_span(doc, spans, tmp_path / "program.json")
    assert idle == pytest.approx({"sched.iteration": 400e-6,
                                  "engine.forward": 100e-6,
                                  P.OUTSIDE: 200e-6})
    summary = bench_trace.summarize(str(path))
    assert sum(idle.values()) == pytest.approx(summary.window_s
                                               - summary.busy_s)
    assert P.launch_share(doc, spans) == (2, 4)
    assert P.kernel_count(doc) == 3
    counts = {"forwards": {"feed": 2, "prefill": 1},
              "rows_run": {"feed": 64, "prefill": 32},
              "rows_real": {"feed": 20, "prefill": 8}}
    r = P.readings(dict(trace_path=path, tracer=tracer, summary=summary,
                        counts=counts))
    assert r["idle_in_forward_share"] == pytest.approx(10.0)
    assert r["idle_in_scheduler_share"] == pytest.approx(40.0)
    assert r["kernels_per_forward"] == pytest.approx(1.0)
    assert r["prefill_useful_row_share"] == pytest.approx(25.0)
    assert r["launch_in_span_share"] == pytest.approx(50.0)
