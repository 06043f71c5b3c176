"""The port's tracer (serving/trace.py) on the CPU: the program spans
(``sched.iteration``, ``engine.forward``, ``engine.to_host``) nest as
they claim, tracing changes no chosen token, the stall buckets still sum
to each stream's wall time, the program spans are opt-in and never
crowd out the charge spans, a span lands on ``torch.profiler``'s clock
after the anchor merge, and the engine counts its forwards and rows.
Port-only: random weights drawn by ``init_params``, the tiny pair at
vocab 64."""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.synera_pair import tiny_pair
from repro_torch.core.offload import OffloadPolicy
from repro_torch.models import model as TM
from repro_torch.serving import synergy as SY
from repro_torch.serving.device import DeviceRuntime
from repro_torch.serving.engine import CloudEngine
from repro_torch.serving.link import RealClock, SimClock
from repro_torch.serving.scheduler import VerificationAwareScheduler
from repro_torch.serving.server import SyneraServer
from repro_torch.serving.synergy import CloudClient
from repro_torch.serving.trace import NULL_TRACER, PROGRAM_KINDS, Tracer

PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1],
           list(range(3, 40))]
MAX_NEW = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    slm, llm = tiny_pair(vocab=64)
    llm = llm.replace(attn_impl="pallas")    # the kernels' wrappers
    return dict(slm=slm, llm=llm,
                slm_p=TM.init_params(slm, 0, device="cpu"),
                llm_p=TM.init_params(llm, 1, device="cpu"))


def _engine(pair, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("s_max", 128)
    return CloudEngine(pair["llm"], pair["llm_p"], device="cpu", **kw)


def _serve(eng, traced: bool):
    """Three streams on a wall clock: their prompts in one prefill, then
    two verify rounds each (the first 12 uncached tokens and 4 drafts:
    two chunks of 8).  Returns the chosen tokens and the tracer."""
    clock = RealClock()
    sched = VerificationAwareScheduler(eng, chunk=8, clock=clock)
    tracer = Tracer(clock) if traced else None
    sched.set_tracer(tracer, program=True)
    clients = [CloudClient(sched) for _ in PROMPTS]
    seqs = [list(p) for p in PROMPTS]
    chosen = []

    def run(rids):
        while rids:
            for ev in sched.run_iteration():
                rids.discard(ev.req_id)
                yield ev

    owner = {c.prefill_async(s): i for i, (c, s) in
             enumerate(zip(clients, seqs))}
    for ev in run(set(owner)):
        clients[owner[ev.req_id]].on_event(ev)
        tok = int(np.argmax(ev.last_logits))
        chosen.append(tok)
        seqs[owner[ev.req_id]].append(tok)
    for rnd in range(2):
        owner = {}
        for i, c in enumerate(clients):
            seqs[i] += [(7 * i + j + rnd) % 64 for j in range(12 - 8 * rnd)]
            owner[c.verify_async(seqs[i], [5, 6, 7, 8], [])] = i
        for ev in run(set(owner)):
            clients[owner[ev.req_id]].on_event(ev)
            chosen += [int(t) for t in ev.result.tokens]
            seqs[owner[ev.req_id]] += [int(t) for t in ev.result.tokens]
    sched.set_tracer(None)
    return chosen, tracer


def _program_spans(tracer, offset_us=0.0):
    return [e for e in tracer.to_events(offset_us)
            if e["ph"] == "X" and e["name"] in PROGRAM_KINDS]


def test_engine_spans_lie_inside_their_iteration(pair):
    _, tracer = _serve(_engine(pair), traced=True)
    spans = _program_spans(tracer)
    by_id = {e["args"]["id"]: e for e in spans}
    iters = [e for e in spans if e["name"] == "sched.iteration"]
    engine = [e for e in spans if e["name"].startswith("engine.")]
    assert {e["args"]["kind"] for e in iters} == {"prefill", "verify"}
    assert len(engine) > len(iters)
    assert {e["name"] for e in engine} == {"engine.forward", "engine.to_host"}
    for e in engine:
        it = by_id[e["args"]["parent"]]
        assert it["name"] == "sched.iteration"
        assert e["args"]["rids"] == it["args"]["rids"]
        assert it["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= it["ts"] + it["dur"]
    for it in iters:
        kids = [e for e in engine if e["args"]["parent"] == it["args"]["id"]]
        fwd = [e for e in kids if e["name"] == "engine.forward"]
        assert fwd and all(e["args"]["entry"] == ("feed" if it["args"][
            "kind"] == "verify" else "prefill") for e in fwd)
        # a prefill reads its last rows; a verify chunk holding none of
        # its requests' last gamma + 1 rows reads nothing
        reads = [e for e in kids if e["name"] == "engine.to_host"]
        assert all(e["args"]["nbytes"] > 0 for e in reads)
        assert reads or it["args"]["kind"] == "verify"
        # a span's rows: the slots it ran x bucket (a prefill runs only
        # the slots with a position), of which those with a position
        for e in fwd:
            a = e["args"]
            assert a["rows_run"] == a["slots"] * a["bucket"]
            assert a["rows_run"] >= a["rows_real"] > 0
            assert (a["slots"] == 4 if a["entry"] == "feed"
                    else 0 < a["slots"] <= 4)


def test_chosen_tokens_and_counters_same_with_tracer_on_and_off(pair):
    off_eng, on_eng = _engine(pair), _engine(pair)
    off, no_tracer = _serve(off_eng, traced=False)
    on, tracer = _serve(on_eng, traced=True)
    assert no_tracer is None and tracer.to_events()
    assert on == off and len(on) > len(PROMPTS)
    assert on_eng.compile_stats == off_eng.compile_stats
    # the engine's counters: every forward once, its rows as its spans say
    stats = on_eng.compile_stats
    fwd = [e["args"] for e in _program_spans(tracer)
           if e["name"] == "engine.forward"]
    for entry in ("feed", "prefill"):
        mine = [a for a in fwd if a["entry"] == entry]
        assert stats["forwards"][entry] == len(mine) > 0
        assert stats["slots_run"][entry] == sum(a["slots"] for a in mine)
        assert stats["rows_run"][entry] == sum(a["rows_run"] for a in mine)
        assert stats["rows_real"][entry] == sum(a["rows_real"] for a in mine)
    assert stats["rows_real"]["prefill"] == sum(map(len, PROMPTS))


def _synera(pair, *, program: bool):
    """``run_synera``'s traced run (three streams at once on a
    ``SimClock``), with the program spans recorded or not."""
    dev = DeviceRuntime(pair["slm"], pair["slm_p"], gamma=4, s_max=128,
                        policy=OffloadPolicy(mode="all"), use_pi=False,
                        device="cpu")
    clock = SimClock()
    tracer = Tracer(clock)
    server = SyneraServer(dev, _engine(pair), chunk=32, clock=clock,
                          tracer=tracer)
    if program:
        server.sched.set_tracer(tracer, program=True)
    return server.serve(PROMPTS, MAX_NEW, concurrency=3), tracer


def test_stall_buckets_sum_to_wall_time_with_program_spans(pair):
    off, _ = _synera(pair, program=False)
    on, tracer = _synera(pair, program=True)
    assert [m.tokens for m in on] == [m.tokens for m in off]
    kinds = {e["name"] for e in _program_spans(tracer)}
    assert kinds == set(PROGRAM_KINDS)
    for m in on:
        tl = m.timeline
        assert tl.bucket_sum == pytest.approx(tl.t_ms, rel=1e-9, abs=1e-9)
    # the round trips stalled (no PI overlap), so attribution ran, and
    # the program spans moved no bucket
    assert all(m.timeline.cloud_ms > 0 for m in on)
    assert [m.timeline.buckets() for m in on] == \
        [m.timeline.buckets() for m in off]


def test_constructor_tracer_records_no_program_spans(pair):
    """A tracer handed to the scheduler's constructor (the gateway's,
    ``run_synera``'s) records the charge spans alone."""
    res = SY.run_synera(DeviceRuntime(
        pair["slm"], pair["slm_p"], gamma=4, s_max=128,
        policy=OffloadPolicy(mode="all"), use_pi=False, device="cpu"),
        _engine(pair), PROMPTS[:1], 8, trace=True)
    tracer = res.extras["tracer"]
    names = {e["name"] for e in tracer.to_events() if e["ph"] == "X"}
    assert "prefill" in names and "verify" in names
    assert not names & set(PROGRAM_KINDS)


def test_program_spans_never_crowd_out_charge_spans():
    """Past ``max_records`` program spans are dropped, and every charge
    span is still kept for attribution."""
    tr = Tracer(SimClock(), max_records=4)
    for i in range(4):
        it = tr.span(10.0 * i, 10.0 * i, "sched.iteration", rids=(i,))
        tr.span(10.0 * i + 1, 10.0 * i + 2, "engine.forward", rids=(i,),
                parent=it)
        tr.span(10.0 * i, 10.0 * i + 10, "verify", rids=(i,))
        tr.span_end(it, 10.0 * i + 10)
    assert tr.dropped == 4
    ev = [e for e in tr.to_events() if e["ph"] == "X"]
    assert sum(e["name"] == "verify" for e in ev) == 4
    assert sum(e["cat"] == "program" for e in ev) == 4
    assert tr.window_parts(0.0, 40.0, vrid=3) == [("wait", 30.0),
                                                  ("cloud", 10.0)]


def test_window_parts_skip_program_spans():
    """Program spans recorded around and out of time order with the
    charge spans change no window's parts."""
    tr = Tracer(SimClock())
    it = tr.span(0.0, 0.0, "sched.iteration", rids=(7,))
    tr.span(2.0, 5.0, "engine.forward", rids=(7,), parent=it)
    tr.span(1.0, 10.0, "verify", rids=(7,))
    tr.span_end(it, 10.0)
    tr.span(10.0, 16.0, "verify", rids=(8,))
    it = tr.span(16.0, 16.0, "sched.iteration", rids=(8,))
    tr.span(17.0, 18.0, "engine.to_host", rids=(8,), parent=it)
    tr.span_end(it, 20.0)
    assert tr.window_parts(0.0, 20.0, vrid=7) == [
        ("cloud", 9.0), ("wait", 6.0), ("other", 5.0)]
    assert tr.window_parts(0.0, 10.0, vrid=8) == [("wait", 9.0),
                                                  ("other", 1.0)]


def test_span_lands_on_the_profiler_clock(tmp_path):
    """A span recorded around a ``record_function`` region lands, once
    moved by ``profiler_offset_us``, within 0.5 ms of the region's ``ts``
    and ``dur`` in the profiler's Chrome export."""
    from torch.profiler import ProfilerActivity, profile, record_function
    clock = RealClock()
    tracer = Tracer(clock)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        t0 = clock.now_ms
        with record_function("region"):
            time.sleep(0.02)
        tracer.span(t0, clock.now_ms, "engine.forward")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    region = next(e for e in doc["traceEvents"]
                  if e.get("name") == "region")
    span, = _program_spans(
        tracer, tracer.profiler_offset_us(doc["baseTimeNanoseconds"]))
    assert abs(span["ts"] - region["ts"]) < 500
    assert abs(span["dur"] - region["dur"]) < 500


def test_engine_counts_forwards_and_rows(pair):
    eng = _engine(pair)
    B, C = eng.max_slots, 8
    tok = np.arange(B * C, dtype=np.int32).reshape(B, C) % 64
    pos = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    pos[1:, 5:] = -1
    eng.prefill(tok, pos)
    eng.feed(tok, np.where(pos >= 0, pos + C, -1).astype(np.int32),
             need_dists=False)
    eng.feed(tok, pos + 2 * C, need_dists=False)
    st = eng.compile_stats
    assert st["forwards"] == {"feed": 2, "prefill": 1}
    assert st["rows_run"] == {"feed": 2 * B * C, "prefill": B * C}
    real = int((pos >= 0).sum())
    assert st["rows_real"] == {"feed": real + B * C, "prefill": real}


def test_set_tracer_installs_on_every_part_and_removes(pair):
    eng = _engine(pair, cache_impl="paged", block_size=16, swap=True,
                  host_swap_blocks=8)
    sched = VerificationAwareScheduler(eng, clock=RealClock(), replica=3)
    parts = (sched, eng, eng.allocator, eng.swap_manager)
    assert all(p.tracer is NULL_TRACER for p in parts)
    tracer = Tracer(sched.clock)
    sched.set_tracer(tracer)
    assert eng.tracer is NULL_TRACER and not sched.trace_program
    assert all(p.tracer is tracer for p in parts if p is not eng)
    sched.set_tracer(tracer, program=True)
    assert all(p.tracer is tracer for p in parts) and sched.trace_program
    assert all(p.trace_replica == 3 for p in parts[1:])
    sched.set_tracer(None)
    assert all(p.tracer is NULL_TRACER for p in parts)
    assert not sched.trace_program
