"""One run of one benchmark cell: repro_torch's cloud verifier
(``VerificationAwareScheduler`` over a dense ``CloudEngine``) on the wall
clock, under closed-loop device streams that the benchmark plays.

The run, in order:

1. set-up: the configuration's weights drawn on the device from the
   seed, the engine, and one feed at every width the traffic can send
   (``setup_s`` ends when the first request is due);
2. the traffic starts and runs ``ramp_s`` seconds unmeasured, so the
   window opens on the steady mix;
3. the window: ``--seconds`` of wall time; every request due inside it
   is measured from its due time to its reply on the host, and the
   served rate is the tokens that the iterations starting inside it
   committed, over the span from the first one's start to the last
   one's end;
4. with ``--trace 1``, a stretch of ``trace_s`` seconds more under
   ``torch.profiler``, with the kernels' calls recorded;
5. the drain: no new request; every request already due gets its reply;
6. the check: the peak memory is read, the engine freed, and the plain
   reference (``bench_reference``) recomputes, over a sample of the
   finished sessions drawn from the seed, the logits at every position
   whose token the program chose; the widest gap between the
   reference's best logit and the chosen token's is held to the
   configuration's limit.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

import bench_counts as K
import bench_traffic

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
STALL_S = 60.0          # no reply for this long: the run fails
DRAIN_S = 60.0          # how long a request due in the window may take


# -- the cell's files -------------------------------------------------------

def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(bm: dict, workload: str) -> tuple[dict, dict]:
    """The workload entry and its configuration entry."""
    cells = {c["name"]: c for c in bm["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bm["configs"]}
    return cell, configs[cell["config"]]


def load_config(root: Path, entry: dict) -> dict:
    return json.loads((Path(root) / entry["file"]).read_text())


def metric_names(bm: dict, workload: str, kind: str) -> list[dict]:
    """The cell's metrics of one kind, ``end_to_end`` or ``per_layer``."""
    return [m for m in bm[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_metric(name: str, bench_dir: Path = BENCH):
    """The reader ``metrics/<name>.py``: a module with ``read(r)`` that
    returns the metric's value or None."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + "".join(c if c.isalnum() else "_"
                                         for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (``names``, default ``sys.modules``) whose top-level
    name, compared whole, is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# -- the program under test -------------------------------------------------

def port_config(cfg: dict, dtype: str | None = None):
    """The configuration file as the port's ``ModelConfig``: the dense
    cache, the hand-written attention kernels (``attn_impl="pallas"``,
    their plain versions on the CPU)."""
    from repro_torch.configs.base import ModelConfig
    moe = bool(cfg.get("num_experts"))
    return ModelConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["moe_intermediate_size"] if moe else
        cfg["intermediate_size"],
        vocab=cfg["vocab_size"], qkv_bias=bool(cfg["attention_bias"]),
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        n_experts=cfg.get("num_experts", 0),
        top_k=cfg.get("num_experts_per_tok", 0), moe_every=1,
        max_verify_chunk=cfg["serve"]["chunk"], cache_impl="dense",
        attn_impl="pallas", dtype=dtype or cfg["torch_dtype"])


def weight_init(path: tuple, cfg: dict) -> tuple[float, float]:
    """(mean, std) of a weight leaf, by its name: the port's init scales,
    with norm weights around 1 and QKV biases drawn, so that both take
    part in every product."""
    d = cfg["hidden_size"]
    ffn = (cfg["moe_intermediate_size"] if "moe" in path
           else cfg.get("intermediate_size", 0))
    name = path[-1]
    rules = {
        "embed": (0.0, 0.02),
        "unembed": (0.0, d ** -0.5),
        "final_norm": (1.0, 0.1), "ln1": (1.0, 0.1), "ln2": (1.0, 0.1),
        "wq": (0.0, d ** -0.5), "wk": (0.0, d ** -0.5),
        "wv": (0.0, d ** -0.5), "wo": (0.0, (2 * d) ** -0.5),
        "bq": (0.0, 0.1), "bk": (0.0, 0.1), "bv": (0.0, 0.1),
        "w_gate": (0.0, d ** -0.5), "w_up": (0.0, d ** -0.5),
        "w_down": (0.0, ffn ** -0.5 if ffn else 0.0),
        "router": (0.0, d ** -0.5),
    }
    if name not in rules:
        raise KeyError(f"no init rule for weight {'/'.join(path)}")
    return rules[name]


def draw_weights(pcfg, cfg: dict, seed: int, device):
    """Every leaf of the tree ``init_params`` lays out (read on ``meta``
    for its shapes and dtypes only), drawn on ``device`` from one
    generator seeded with ``seed``, one call a leaf, in the leaf's dtype."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import flatten, unflatten
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    paths, leaves = [], []
    for path, leaf in flatten(M.init_params(pcfg, device="meta")):
        mean, std = weight_init(path, cfg)
        t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        t.normal_(mean, std, generator=gen)
        paths.append(path)
        leaves.append(t)
    return unflatten(paths, leaves)


def warm_up(eng, traffic: bench_traffic.Traffic) -> None:
    """One prefill at every feed width the cell's prompts can take (the
    engine's sub-chunks are cut to its bucket ladder), and one verify
    feed, on every slot; then every slot is reset."""
    B = eng.max_slots
    buckets = eng.feed_buckets
    cap = buckets[-1]
    widths = set()
    for C in range(int(traffic.spec["prompt_tokens"]["min"]),
                   int(traffic.spec["prompt_tokens"]["max"]) + 1):
        for off in range(0, C, cap):
            w = min(cap, C - off)
            widths.add(next(b for b in buckets if w <= b))
    for w in sorted(widths, reverse=True):
        tok = np.zeros((B, w), np.int32)
        pos = np.broadcast_to(np.arange(w, dtype=np.int32), (B, w)).copy()
        eng.prefill(tok, pos)
        for s in range(B):
            eng.reset_slot(s)
    C = eng.cfg.max_verify_chunk
    pos = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    eng.feed(np.zeros((B, C), np.int32), pos, need_dists=False)
    for s in range(B):
        eng.reset_slot(s)


# -- the device streams -----------------------------------------------------

@dataclass
class Request:
    kind: str                   # "prefill" | "verify"
    stream: int
    due: float                  # ms on the scheduler's clock
    positions: np.ndarray       # absolute positions this request feeds
    new_tokens: np.ndarray = None  # device tokens this round commits
    reply: float | None = None
    committed: int = 0


@dataclass
class Stream:
    index: int
    client: object = None
    session: object = None
    target: int = 0             # output tokens this session commits
    seq: list = field(default_factory=list)
    out: int = 0
    served: list = field(default_factory=list)  # (index in seq, token)


class Run:
    """The closed loop over one scheduler, and what it recorded."""

    def __init__(self, sched, clock, traffic, cfg):
        self.sched = sched
        self.clock = clock
        self.traffic = traffic
        self.cfg = cfg
        self.next_session = 0
        self.requests: dict[int, Request] = {}
        self.iterations: list[dict] = []
        self.finished: list[dict] = []     # sessions, for the check
        self.submitting = True
        # record_function while traced, a no-op otherwise
        self.annotate = lambda name: contextlib.nullcontext()
        self.t0 = self.t1 = float("inf")
        self.streams = [Stream(i) for i in range(traffic.streams)]

    # sessions and rounds
    def start(self, now: float) -> None:
        for st in self.streams:
            self._new_session(st, now, first=True)

    def _new_session(self, st: Stream, now: float, first=False) -> None:
        from repro_torch.serving.synergy import CloudClient
        ses = self.traffic.session(self.next_session)
        self.next_session += 1
        st.session = ses
        st.target = (self.traffic.first_output(ses, st.index) if first
                     else ses.output)
        st.seq = [int(t) for t in ses.prompt]
        st.out = 0
        st.served = []
        st.client = CloudClient(self.sched)
        rid = st.client.prefill_async(st.seq, arrival_ms=now)
        self.requests[rid] = Request("prefill", st.index, now,
                                     np.arange(len(st.seq)))

    def _next_round(self, st: Stream, now: float) -> None:
        dev, draft = self.traffic.round(st.session)
        frontier = st.client.frontier()
        seq = st.seq + [int(t) for t in dev]
        rid = st.client.verify_async(seq, [int(t) for t in draft], [],
                                     arrival_ms=now)
        n = len(seq) - frontier + len(draft)
        self.requests[rid] = Request("verify", st.index, now,
                                     np.arange(frontier, frontier + n),
                                     new_tokens=dev)

    def _on_event(self, ev, now: float) -> None:
        req = self.requests[ev.req_id]
        req.reply = now
        st = self.streams[req.stream]
        if ev.kind == "prefill_done":
            st.client.on_event(ev)
            tok = int(np.argmax(ev.last_logits))
            st.served.append((len(st.seq), tok))
            st.seq.append(tok)
            req.committed = 1
        else:
            st.seq.extend(int(t) for t in req.new_tokens)
            for tok in ev.result.tokens:
                st.served.append((len(st.seq), int(tok)))
                st.seq.append(int(tok))
            req.committed = len(req.new_tokens) + len(ev.result.tokens)
        st.out += req.committed
        if st.out >= st.target:
            self.finished.append(dict(session=st.session.index,
                                      tokens=list(st.seq),
                                      served=list(st.served), end=now))
            st.client.release()
            if self.submitting:
                self._new_session(st, now)
        elif self.submitting:
            self._next_round(st, now)

    # the loop
    def iterate(self) -> list:
        s = self.sched
        p0, v0 = s.prefill_iterations, s.verify_iterations
        t_start = self.clock.now_ms
        with self.annotate("scheduler.run_iteration"):
            evs = s.run_iteration()
        now = self.clock.now_ms
        kind = ("prefill" if s.prefill_iterations > p0 else
                "verify" if s.verify_iterations > v0 else None)
        if kind is not None:
            self.iterations.append(dict(
                kind=kind, start=t_start, end=now, events=len(evs),
                slots=(s.verify_occupancy[-1] if kind == "verify"
                       else len(evs)),
                rids=[e.req_id for e in evs]))
        with self.annotate("bench.streams"):
            for ev in evs:
                self._on_event(ev, now)
        return evs

    def run_until(self, t_ms: float) -> None:
        last = time.monotonic()
        while self.clock.now_ms < t_ms:
            if self.iterate():
                last = time.monotonic()
            elif time.monotonic() - last > STALL_S:
                raise RuntimeError("no reply for a minute: the loop stalled")

    def drain(self) -> None:
        self.submitting = False
        end = time.monotonic() + DRAIN_S
        while self.sched.has_work() and time.monotonic() < end:
            self.iterate()

    # what the window saw
    def window_requests(self, kind: str) -> list[Request]:
        return [r for r in self.requests.values()
                if r.kind == kind and self.t0 <= r.due < self.t1]

    def window_iterations(self, kind: str | None = None) -> list[dict]:
        return [it for it in self.iterations
                if self.t0 <= it["start"] < self.t1
                and (kind is None or it["kind"] == kind)]

    def window_span_s(self) -> float:
        """Seconds from the start of the window's first iteration to the
        end of its last."""
        its = self.window_iterations()
        return (its[-1]["end"] - its[0]["start"]) / 1e3 if its else 0.0

    def window_flops(self) -> int:
        """Useful operations of the rows that the window's iterations
        ran: each finished request's real positions."""
        total = 0
        for it in self.window_iterations():
            for rid in it["rids"]:
                total += K.model_flops(self.cfg, self.requests[rid].positions)
        return total


# -- the metrics ------------------------------------------------------------

def p95(values) -> float | None:
    return float(np.percentile(values, 95)) if len(values) else None


def end_to_end(run: Run) -> dict:
    ver = run.window_requests("verify")
    pre = run.window_requests("prefill")
    rtt = [r.reply - r.due for r in ver if r.reply is not None]
    ttft = [r.reply - r.due for r in pre if r.reply is not None]
    served = sum(run.requests[rid].committed
                 for it in run.window_iterations() for rid in it["rids"])
    span = run.window_span_s()
    return {"served_tokens_per_s": served / span if span else None,
            "verify_rtt_p95_ms": p95(rtt),
            "ttft_p95_ms": p95(ttft)}


@dataclass
class Readings:
    """What a per-layer metric's reader may read."""
    cfg: dict
    window_s: float             # the window's iterations' span
    iterations: list            # the window's iterations (dicts)
    useful_flops: int           # of the window's iterations
    trace: object = None        # bench_trace.TraceSummary of the stretch
    stretch_useful_rows: int = 0
    calls: dict = field(default_factory=dict)  # kernel -> recorded calls


class CallRecorder:
    """Records each ``partial_prefill_attention`` and ``grouped_mm`` call
    of the port's layers (their shapes and the tensors their counts need;
    read after the stretch, so no call waits for the device).  Every
    forward of the engine runs ``partial_prefill_attention`` once a layer
    on all its rows (its feeds are 8 rows wide or more), so the recorded
    queries also count the rows each forward ran."""

    def __init__(self):
        self.calls = {"partial_prefill": [], "grouped_mm": []}
        self._saved = {}

    def __enter__(self):
        from repro_torch.models import layers as L
        pp, gmm = L.partial_prefill_attention, L.grouped_mm
        self._saved = {"partial_prefill_attention": pp, "grouped_mm": gmm}

        def rec_pp(q, k, v, q_pos, kv_pos, **kw):
            self.calls["partial_prefill"].append(
                (tuple(q.shape), tuple(k.shape), q_pos, q.element_size()))
            return pp(q, k, v, q_pos, kv_pos, **kw)

        def rec_gmm(x, w, ends):
            self.calls["grouped_mm"].append(
                (x.shape[0], x.shape[1], w.shape[2], ends, x.element_size()))
            return gmm(x, w, ends)

        L.partial_prefill_attention = rec_pp
        L.grouped_mm = rec_gmm
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        for name, fn in self._saved.items():
            setattr(L, name, fn)
        return False

    def host(self) -> dict:
        """The recorded calls with their tensors read to the host."""
        return {
            "partial_prefill": [(qs, ks, qp.cpu().numpy(), e)
                                for qs, ks, qp, e in
                                self.calls["partial_prefill"]],
            "grouped_mm": [(m, k, n, ends.cpu().numpy(), e)
                           for m, k, n, ends, e in self.calls["grouped_mm"]],
        }


def traced_stretch(run: Run, seconds: float, trace_path: Path):
    """``seconds`` more of the loop under ``torch.profiler``: returns the
    trace's summary, the useful rows the scheduler fed, and the kernels'
    recorded calls."""
    import torch
    import bench_trace
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    s = run.sched
    fed0 = s.prefill_fed_tokens + sum(s.verify_tokens_fed)
    annotate, run.annotate = run.annotate, record_function
    with CallRecorder() as rec, profile(activities=acts) as prof:
        with record_function(bench_trace.STRETCH):
            end = run.clock.now_ms + seconds * 1e3
            while run.clock.now_ms < end:
                run.iterate()
    run.annotate = annotate
    rows = s.prefill_fed_tokens + sum(s.verify_tokens_fed) - fed0
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    return bench_trace.summarize(str(trace_path)), rows, rec.host()


# -- the check --------------------------------------------------------------

def pick_sample(finished: list[dict], seed: int, served_target: int,
                max_tokens: int) -> list[dict]:
    """Finished sessions drawn from the seed, the longest first, until
    ``served_target`` chosen tokens are in or the next would pass
    ``max_tokens`` tokens in all."""
    if not finished:
        return []
    rng = np.random.default_rng([int(seed) % 2**63, 3])
    longest = max(finished, key=lambda f: (len(f["tokens"]), f["session"]))
    rest = [f for f in sorted(finished, key=lambda f: f["session"])
            if f is not longest]
    out, served, tokens = [longest], len(longest["served"]), \
        len(longest["tokens"])
    for i in rng.permutation(len(rest)):
        if served >= served_target:
            break
        f = rest[int(i)]
        if tokens + len(f["tokens"]) > max_tokens:
            continue
        out.append(f)
        served += len(f["served"])
        tokens += len(f["tokens"])
    return out


def logit_gaps(cfg: dict, weights: dict, sample: list[dict],
               control: bool = False):
    """For every chosen token of the sample, the reference's best logit
    at its row less the reference's logit of the token; with
    ``control``, also the same for the token that the fp8 reference puts
    first there in its place.  Returns (gaps, control gaps or None)."""
    import torch
    import bench_reference as R
    streams = [f["tokens"][:max(p for p, _ in f["served"])]
               for f in sample]
    rows = [[p - 1 for p, _ in f["served"]] for f in sample]
    ref = R.logits_at(cfg, weights, streams, rows, "f32")
    ctl = (R.logits_at(cfg, weights, streams, rows, "fp8") if control
           else None)

    def gaps_of(picks):
        out = [(lg.max(-1).values - lg.gather(1, t.long()[:, None])[:, 0])
               .cpu().numpy() for lg, t in zip(ref, picks)]
        return np.concatenate(out) if out else np.zeros(0)

    served = [torch.as_tensor([t for _, t in f["served"]],
                              device=lg.device) for f, lg in zip(sample, ref)]
    return (gaps_of(served),
            gaps_of([c.argmax(-1) for c in ctl]) if control else None)


def gap_numbers(gaps: np.ndarray) -> dict:
    """The numbers a check can compare: the widest gap, and the mean gap
    over every chosen token (steadier where routing near a tie flips an
    expert between precisions)."""
    if not gaps.size:
        return {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf")}
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean())}


def verdict(chk: dict, numbers: dict, tokens: int, unanswered: int) -> bool:
    """``correct``: every compared number within its limit, enough tokens
    checked, and every request due in the window answered."""
    return bool(all(numbers[n] <= lim for n, lim in chk["limits"].items())
                and tokens >= chk["min_tokens_checked"] and unanswered == 0)


# -- one run ----------------------------------------------------------------

def device_info(torch, trace) -> dict:
    if torch.cuda.is_available():
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def smi(fields: str) -> str:
    """One line of ``nvidia-smi --query-gpu`` for the first card."""
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return res.stdout.strip().splitlines()[0] if res.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def host_state() -> dict:
    """The host's load and mean core clock, and the card's clocks,
    temperature, power and throttle reasons, read as the window closes:
    what a run's speed may follow besides the code."""
    out = {"loadavg": None, "cpu_mhz": None,
           "cpus": len(os.sched_getaffinity(0))}
    with contextlib.suppress(OSError):
        out["loadavg"] = open("/proc/loadavg").read().split()[:3]
    with contextlib.suppress(OSError, ValueError):
        mhz = [float(line.split(":")[1]) for line in open("/proc/cpuinfo")
               if line.startswith("cpu MHz")]
        out["cpu_mhz"] = sum(mhz) / len(mhz) if mhz else None
    out["card"] = smi("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
                      "clocks_throttle_reasons.active")
    return out


def run_cell(cfg: dict, spec: dict, *, seed: int, seconds: float,
             trace: bool, metrics: list[str], per_layer: list[str],
             device: str = "cuda", t_start: float | None = None,
             trace_path: Path | None = None, dtype: str | None = None,
             control: bool = False, bench_dir: Path = BENCH) -> dict:
    """One run of the cell given by its configuration and traffic dicts;
    returns the result's fields (``metrics`` holds the end-to-end
    metrics named in ``metrics`` and, with ``trace``, the per-layer ones
    in ``per_layer``)."""
    import torch
    from repro_torch.serving.engine import CloudEngine
    from repro_torch.serving.link import RealClock
    from repro_torch.serving.scheduler import VerificationAwareScheduler
    t_start = time.monotonic() if t_start is None else t_start
    srv = cfg["serve"]
    traffic = bench_traffic.Traffic(spec, cfg["vocab_size"], seed)
    if traffic.longest_stream() > srv["s_max"]:
        raise ValueError(f"traffic reaches {traffic.longest_stream()} "
                         f"tokens, past s_max {srv['s_max']}")
    pcfg = port_config(cfg, dtype)
    weights = draw_weights(pcfg, cfg, seed, device)
    eng = CloudEngine(pcfg, weights, max_slots=srv["slots"],
                      s_max=srv["s_max"], device=device)
    warm_up(eng, traffic)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    clock = RealClock()
    sched = VerificationAwareScheduler(eng, chunk=srv["chunk"], clock=clock)
    run = Run(sched, clock, traffic, cfg)
    now = clock.now_ms
    setup_s = time.monotonic() - t_start
    run.start(now)
    run.t0 = now + float(spec["ramp_s"]) * 1e3
    run.t1 = run.t0 + seconds * 1e3
    run.run_until(run.t0)
    cpu0 = time.process_time()
    run.run_until(run.t1)
    host = {"process_cpu_share": (time.process_time() - cpu0)
            / ((run.clock.now_ms - run.t0) / 1e3)}
    if device != "cpu":
        host.update(host_state())
    summary = rows = calls = None
    if trace:
        summary, rows, calls = traced_stretch(
            run, float(spec["trace_s"]),
            trace_path or BENCH.parent / "build" / "bench" / "trace.json")
    run.drain()
    info = device_info(torch, summary)
    e2e = end_to_end(run)
    e2e["setup_s"] = setup_s
    units = {"served_tokens_per_s": "tokens/s", "verify_rtt_p95_ms": "ms",
             "ttft_p95_ms": "ms", "setup_s": "s"}
    out_metrics = {}
    if not trace:
        for name in metrics:
            if e2e.get(name) is not None:
                out_metrics[name] = {"value": e2e[name], "unit": units[name]}
    else:
        r = Readings(cfg=cfg, window_s=run.window_span_s(),
                     iterations=run.window_iterations(),
                     useful_flops=run.window_flops(), trace=summary,
                     stretch_useful_rows=rows, calls=calls)
        for name, unit in per_layer:
            value = load_metric(name, bench_dir).read(r)
            if value is not None:
                out_metrics[name] = {"value": float(value), "unit": unit}
    due = run.window_requests("prefill") + run.window_requests("verify")
    failed = sum(1 for r in due if r.reply is None)
    # the program's state is freed before the reference runs
    finished = [f for f in run.finished if f["end"] >= run.t0]
    del run, sched, eng
    if device != "cpu":
        torch.cuda.empty_cache()
    chk = cfg["check"]
    sample = pick_sample(finished, seed, chk["served_tokens"],
                         chk["max_tokens"])
    gaps, cgaps = logit_gaps(cfg, weights, sample, control=control)
    numbers = gap_numbers(gaps)
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in chk["limits"].items()}
    checks["tokens_checked"] = {"value": int(gaps.size),
                                "limit": chk["min_tokens_checked"]}
    checks["unanswered"] = {"value": failed, "limit": 0}
    correct = verdict(chk, numbers, gaps.size, failed)
    result = {"correct": correct, "attempted": len(due),
              "failed": failed, "metrics": out_metrics, "device": info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps()}
    if control:
        cnum = gap_numbers(cgaps)
        result["control"] = {"program": gaps, "control": cgaps,
                             "numbers": cnum,
                             "correct": verdict(chk, cnum, cgaps.size,
                                                failed)}
    result["end_to_end"] = e2e
    result["host"] = host
    result["gaps"] = numbers
    result["checks"] = checks
    return result


# -- the command ------------------------------------------------------------

def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, *, root: Path, t_start: float) -> int:
    args = parse(argv)
    bm = load_benchmark(root)
    cell, entry = find_cell(bm, args.workload)
    cfg = load_config(root, entry)
    spec = bench_traffic.load(root / "bench", cell["traffic"])
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"bench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    e2e = [m["name"] for m in metric_names(bm, args.workload, "end_to_end")]
    pl = [(m["name"], m["unit"])
          for m in metric_names(bm, args.workload, "per_layer")]
    res = run_cell(cfg, spec, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), metrics=e2e, per_layer=pl,
                   device="cuda", t_start=t_start, bench_dir=root / "bench",
                   trace_path=root / "build" / "bench"
                   / f"trace.{args.workload}.json")
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded in this process: {bad} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 4
    res["device"]["power_limit"] = smi("name,power.limit")
    extra = {k: res.pop(k) for k in ("end_to_end", "gaps", "host")}
    checks = res.pop("checks")
    print(json.dumps(extra), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    res["checks"] = checks
    print(json.dumps(res))
    return 0
