#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # one CUDA card; no arguments

Phase 1 builds the hand-written kernels from ``src/repro_torch/kernels/
csrc`` with nvcc for sm_90a.  Phase 2 holds each kernel against its plain
PyTorch version on the card at the main path's shapes (plus a GQA shape),
in float32 and bfloat16, and times kernel, plain version and one library
call with L2 flushed before each timed call.  Phase 3 serves ``run_synera`` and ``run_cloud_centric`` end to end
with the paper's SLM/LLM pair at full width (random weights from a seed)
and checks that every kernel of the path was launched.  Phase 4 runs the
tiny pair in float32 twice -- through the kernels and through the plain
attention paths -- and requires identical greedy token streams.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without that line.  The port never imports JAX; neither does
this script.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": (2e-5, 2e-5), "torch.bfloat16": (5e-2, 5e-2)}
IMP_ATOL = 1e-3

KERNEL_INFO = {
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_gqa.cu",
        replaces="src/repro/kernels/decode_gqa/decode_gqa.py:71"),
    "partial_prefill_attention": dict(
        source="src/repro_torch/kernels/csrc/partial_prefill.cu",
        replaces="src/repro/kernels/partial_prefill/partial_prefill.py:78"),
    "attn_with_importance": dict(
        source="src/repro_torch/kernels/csrc/attn_importance.cu",
        replaces="src/repro/kernels/attn_importance/attn_importance.py:74"),
}


def log(*a):
    print(*a, flush=True)


def kernel_modules():
    from repro_torch.kernels import attn_importance, decode_gqa, partial_prefill
    return {"decode_attention": decode_gqa,
            "partial_prefill_attention": partial_prefill,
            "attn_with_importance": attn_importance}


def reset_launches():
    for mod in kernel_modules().values():
        mod.launches = 0


def read_launches():
    return {name: mod.launches for name, mod in kernel_modules().items()}


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(reports)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cache_positions(rng, B, S, C, lo, hi, pad_rows=True):
    """Per-slot cache fill of L in [lo, hi) positions and a chunk of up to
    C queries at the tail (write-then-attend), padded with -1."""
    qp = np.full((B, C), -1, np.int32)
    kp = np.full((B, S), -1, np.int32)
    for b in range(B):
        L = int(rng.integers(lo, hi))
        nq = int(rng.integers(1, C + 1)) if pad_rows else C
        kp[b, :L + nq] = np.arange(L + nq)
        qp[b, :nq] = L + np.arange(nq)
    return qp, kp


def _bytes_flops(q, k, out_bytes, valid, nh, hd, extra_bytes=0):
    """Least bytes (inputs read once, outputs written once; only the K/V
    rows some query may attend to) and flops (QK and PV over valid
    (query, key) pairs) for one call."""
    esz = q.element_size()
    nkv = k.shape[2]
    needed_rows = int(valid.reshape(valid.shape[0], -1, valid.shape[-1])
                      .any(dim=1).sum())
    n_pairs = int(valid.sum())
    nbytes = (q.numel() * esz + out_bytes + extra_bytes
              + 2 * needed_rows * nkv * hd * esz)
    flops = 4 * hd * nh * n_pairs
    return nbytes, flops


L2_FLUSH_BYTES = 256 << 20       # five times the H100's 50 MB L2


def _time_ms(fn, iters=20, warmup=3, cold=True):
    """Mean ms of one call of ``fn`` (CUDA events around each call).  With
    ``cold`` a 256 MB buffer is written before every timed call, so the
    call finds none of its inputs in L2 -- as on the main path, where the
    other layers' K/V and the weights pass through L2 between two uses of
    one layer's cache."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        if cold:
            flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


def _close(a, b, atol, rtol):
    return bool(((a.float() - b.float()).abs()
                 <= atol + rtol * b.float().abs()).all())


def _case(name, shape, dtype, seed):
    """Inputs for one kernel check, on the card."""
    import torch
    dev = "cuda"
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev).to(dtype)

    if name == "decode_attention":
        B, S, nh, nkv, hd, lo, hi = shape
        qp, kp = _cache_positions(rng, B, S, 1, lo, hi, pad_rows=False)
        return dict(q=randn(B, nh, hd), k=randn(B, S, nkv, hd),
                    v=randn(B, S, nkv, hd),
                    q_pos=torch.from_numpy(qp[:, 0].copy()).to(dev),
                    kv_pos=torch.from_numpy(kp).to(dev))
    B, C, S, nh, nkv, hd, lo, hi = shape
    qp, kp = _cache_positions(rng, B, S, C, lo, hi,
                              pad_rows=name != "attn_with_importance")
    return dict(q=randn(B, C, nh, hd), k=randn(B, S, nkv, hd),
                v=randn(B, S, nkv, hd), q_pos=torch.from_numpy(qp).to(dev),
                kv_pos=torch.from_numpy(kp).to(dev))


def _valid(name, a):
    kp, qp = a["kv_pos"], a["q_pos"]
    if name == "decode_attention":
        return ((kp >= 0) & (kp <= qp[:, None]))[:, None, :]
    return (kp[:, None, :] >= 0) & (qp[:, :, None] >= 0) \
        & (kp[:, None, :] <= qp[:, :, None])


def _library_call(name, a):
    """One PyTorch call computing the same function (a yardstick only; the
    port never calls it), or None."""
    import torch
    import torch.nn.functional as F
    if name == "attn_with_importance":
        return None
    q = a["q"][:, None] if name == "decode_attention" else a["q"]
    qt = q.transpose(1, 2).contiguous()
    kt = a["k"].transpose(1, 2).contiguous()
    vt = a["v"].transpose(1, 2).contiguous()
    mask = _valid(name, a)[:, None]
    gqa = qt.shape[1] != kt.shape[1]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)


# (kernel, label, shape, main-path?)  Shapes: decode (B, S, nh, nkv, hd,
# fill lo, fill hi); others (B, C, S, nh, nkv, hd, fill lo, fill hi).  The
# fills match phase 3: prompts of 64-256 tokens plus 32 generated.
KERNEL_CASES = [
    ("decode_attention", "cloud decode", (8, 2048, 32, 32, 128, 64, 320), True),
    ("decode_attention", "gqa g=4", (4, 1024, 32, 8, 128, 64, 900), False),
    ("partial_prefill_attention", "cloud verify C=32",
     (8, 32, 2048, 32, 32, 128, 64, 288), True),
    ("partial_prefill_attention", "cloud prefill C=256",
     (8, 256, 2048, 32, 32, 128, 0, 1), False),
    ("partial_prefill_attention", "device prompt feed",
     (1, 127, 512, 12, 12, 64, 0, 1), False),
    ("partial_prefill_attention", "gqa g=4", (2, 16, 512, 16, 4, 64, 32, 400),
     False),
    ("attn_with_importance", "device draft", (1, 1, 512, 12, 12, 64, 64, 288),
     True),
    ("attn_with_importance", "gqa g=4", (2, 8, 256, 8, 2, 64, 32, 200), False),
]


def phase_kernels():
    import torch
    mods = kernel_modules()
    plain = {"decode_attention": mods["decode_attention"].decode_attention_ref,
             "partial_prefill_attention":
                 mods["partial_prefill_attention"].partial_prefill_ref,
             "attn_with_importance":
                 mods["attn_with_importance"].attn_with_importance_ref}
    main = {}
    ok = True
    for i, (name, label, shape, is_main) in enumerate(KERNEL_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            a = _case(name, shape, dtype, seed=100 + i)
            kern = getattr(mods[name], name)
            out_k = kern(**a)
            out_p = plain[name](**a)
            torch.cuda.synchronize()
            atol, rtol = TOL[str(dtype)]
            if name == "attn_with_importance":
                (ok_, ik), (op, ip) = out_k, out_p
                good = (_close(ok_, op, atol, rtol)
                        and _close(ik, ip, IMP_ATOL, 0.0))
                err = max(float((ok_.float() - op.float()).abs().max()),
                          float((ik - ip).abs().max()))
                out_bytes = ok_.numel() * ok_.element_size() + ik.numel() * 4
            else:
                good = _close(out_k, out_p, atol, rtol)
                err = float((out_k.float() - out_p.float()).abs().max())
                out_bytes = out_k.numel() * out_k.element_size()
                if name == "partial_prefill_attention":
                    pad = a["q_pos"] < 0
                    good = good and bool((out_k[pad] == 0).all())
            valid = _valid(name, a)
            nh, hd = a["q"].shape[-2], a["q"].shape[-1]
            pos_bytes = (a["q_pos"].numel() + a["kv_pos"].numel()) * 4
            nbytes, flops = _bytes_flops(a["q"], a["k"], out_bytes, valid,
                                         nh, hd, extra_bytes=pos_bytes)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / PEAK_FLOPS[str(dtype)] * 1e3
            ms = _time_ms(lambda: kern(**a))
            warm_ms = _time_ms(lambda: kern(**a), cold=False)
            plain_ms = _time_ms(lambda: plain[name](**a), iters=5)
            lib = _library_call(name, a)
            lib_ms = _time_ms(lib) if lib is not None else None
            rec = dict(name=name, case=label, dtype=str(dtype),
                       shape=list(shape), ok=good, max_abs_err=err, ms=ms,
                       ms_l2_warm=warm_ms, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       bound_ms=max(t_bytes, t_flops),
                       bound_by="bytes" if t_bytes >= t_flops else
                       "operations")
            log("[kernels] " + json.dumps(rec))
            ok = ok and good
            if is_main and dtype == torch.bfloat16:
                main[name] = rec
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version")
    return main


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------

class HostTimer:
    """Wall seconds spent inside wrapped callables, by bucket.  Each
    wrapped call ends in a host copy of its result (a device sync), so
    its wall time includes the device work it queued."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._undo = []

    def wrap(self, obj, name: str, bucket: str):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[bucket] = (self.seconds.get(bucket, 0.0)
                                        + time.perf_counter() - t0)

        setattr(obj, name, timed)
        self._undo.append((obj, name, fn))

    def restore(self):
        for obj, name, fn in reversed(self._undo):
            setattr(obj, name, fn)
        self._undo.clear()


def profile_device_share(fn):
    """Run ``fn`` under torch.profiler (device activity only, to keep the
    trace small); returns (wall s, summed kernel time s, top kernels
    [(name, s, calls)]), or None when the profiler reports no device
    time.  The profiler slows the host, so the share is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((ev.key, us / 1e6, ev.count))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows[:8]


def outputs_sha(outputs) -> str:
    return hashlib.sha256(json.dumps(
        [[int(t) for t in o] for o in outputs]).encode()).hexdigest()[:16]


def phase_full_width():
    import torch
    from repro_torch.configs.synera_pair import SYNERA_LLM, SYNERA_SLM
    from repro_torch.core.offload import OffloadPolicy
    from repro_torch.models import model as M
    from repro_torch.serving import synergy as SY
    from repro_torch.serving.device import DeviceRuntime
    from repro_torch.serving.engine import CloudEngine

    slm_cfg = SYNERA_SLM.replace(attn_impl="pallas")
    llm_cfg = SYNERA_LLM.replace(attn_impl="pallas")
    t0 = time.perf_counter()
    slm_p = M.init_params(slm_cfg, seed=0, device="cuda")
    llm_p = M.init_params(llm_cfg, seed=1, device="cuda")
    dev = DeviceRuntime(slm_cfg, slm_p, s_max=512, gamma=4,
                        policy=OffloadPolicy(mode="all"), device="cuda")
    eng = CloudEngine(llm_cfg, llm_p, max_slots=8, s_max=2048, device="cuda")
    torch.cuda.synchronize()
    log(f"[full] init {time.perf_counter() - t0:.3f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, slm_cfg.vocab, int(n)).tolist()
               for n in (64, 128, 192, 256)]
    prompts.append([11, 12])        # one-token device prompt feed: decode
    max_new = 32

    from repro_torch.serving import device as device_mod
    timer = HostTimer()
    timer.wrap(dev, "_one_token", "device SLM token step")
    timer.wrap(dev, "_prefill", "device prompt feed")
    timer.wrap(device_mod.EE, "pick_exit_layer", "early-exit pick (host)")
    for name in ("feed", "prefill"):
        timer.wrap(eng, name, f"cloud engine.{name}")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = SY.run_synera(dev, eng, prompts, max_new, concurrency=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    synera_launches = read_launches()
    timer.restore()
    log("[full] run_synera host time by part (s): " + json.dumps(
        {k: round(v, 3) for k, v in timer.seconds.items()}))
    n_tok = sum(len(o) for o in res.outputs)
    log(f"[full] run_synera: {len(prompts)} prompts, {n_tok} tokens in "
        f"{wall:.2f} s wall ({n_tok / wall:.1f} tokens/s); modeled TBT "
        f"{res.tbt_ms:.2f} ms; sha {outputs_sha(res.outputs)}; launches "
        f"{json.dumps(synera_launches)}")
    log(f"[full] scheduler: " + json.dumps(
        {k: res.extras['scheduler'][k] for k in
         ('iterations', 'prefill_iterations', 'verify_iterations',
          'mean_verify_occupancy', 'sim_ms')}))
    for o in res.outputs:
        if len(o) != max_new or not all(0 <= t < llm_cfg.vocab for t in o):
            raise RuntimeError(f"bad run_synera output {o}")
    missing = [k for k, n in synera_launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"main path never launched {missing}")

    reset_launches()
    t0 = time.perf_counter()
    rc = SY.run_cloud_centric(eng, prompts[:1], 8)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    cloud_launches = read_launches()
    log(f"[full] run_cloud_centric: 8 tokens in {wall_c:.2f} s wall; "
        f"modeled TBT {rc.tbt_ms:.2f} ms; launches "
        f"{json.dumps(cloud_launches)}")
    if len(rc.outputs[0]) != 8 or cloud_launches["decode_attention"] == 0:
        raise RuntimeError("cloud-centric decode did not run its kernel")

    prof = profile_device_share(
        lambda: SY.run_synera(dev, eng, prompts[:2], 4, concurrency=2))
    if prof is None:
        log("[full] profiler: no device time reported (device share not "
            "measured)")
    else:
        pw, busy, top = prof
        log(f"[full] profiled run_synera (2 prompts, max_new=4): wall "
            f"{pw:.2f} s, kernel time {busy:.3f} s, device busy share "
            f"{busy / pw:.3f}")
        for name, sec, calls in top:
            log(f"[full]   {sec:8.4f} s {calls:7d} calls  {name[:90]}")

    # full-width forward: kernel path against the plain attention path
    toks = torch.tensor([prompts[0][:48]], device="cuda")
    pos = M.default_positions(1, 48, device="cuda")
    with torch.no_grad():
        lk = M.forward(llm_cfg, llm_p, toks, pos)[0].float()
        lp = M.forward(llm_cfg.replace(attn_impl="naive"), llm_p, toks,
                       pos)[0].float()
    cos = float(torch.nn.functional.cosine_similarity(
        lk.flatten(), lp.flatten(), dim=0))
    log(f"[full] LLM forward T=48: finite={bool(torch.isfinite(lk).all())}, "
        f"cosine(kernel, plain)={cos:.6f}, "
        f"max|diff|={float((lk - lp).abs().max()):.4f}")
    if not bool(torch.isfinite(lk).all()) or cos < 0.99:
        raise RuntimeError("full-width forward disagrees with plain path")
    del eng, dev, llm_p, slm_p
    torch.cuda.empty_cache()
    return synera_launches


# ---------------------------------------------------------------------------
# Phase 4: tiny pair, kernels vs plain paths, token identity
# ---------------------------------------------------------------------------

def phase_tiny_identity():
    from repro_torch.configs.synera_pair import tiny_pair
    from repro_torch.core.offload import OffloadPolicy
    from repro_torch.models import model as M
    from repro_torch.serving import synergy as SY
    from repro_torch.serving.device import DeviceRuntime
    from repro_torch.serving.engine import CloudEngine

    slm_cfg, llm_cfg = tiny_pair(vocab=64)
    slm_p = M.init_params(slm_cfg, seed=0, device="cuda")
    llm_p = M.init_params(llm_cfg, seed=1, device="cuda")
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1], [5, 9]]
    shas = {}
    for impl in ("pallas", "plain"):
        sc = slm_cfg.replace(attn_impl="pallas" if impl == "pallas"
                             else "naive")
        lc = llm_cfg.replace(attn_impl="pallas" if impl == "pallas"
                             else "blocked")
        dev = DeviceRuntime(sc, slm_p, gamma=4, s_max=256, device="cuda",
                            policy=OffloadPolicy(c_th=0.8, i_th=0.04,
                                                 mode="both"))
        eng = CloudEngine(lc, llm_p, max_slots=4, s_max=256, device="cuda")
        r1 = SY.run_synera(dev, eng, prompts, 24, concurrency=2)
        r2 = SY.run_cloud_centric(eng, prompts[:1], 12)
        shas[impl] = (outputs_sha(r1.outputs), outputs_sha(r2.outputs))
        log(f"[tiny] {impl}: run_synera sha {shas[impl][0]}, "
            f"run_cloud_centric sha {shas[impl][1]}, offloaded "
            f"{sum(m.n_offloaded for m in r1.metrics)} chunks")
    if shas["pallas"] != shas["plain"]:
        raise RuntimeError(f"token streams differ: {shas}")


# ---------------------------------------------------------------------------

def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.runtime import resolve_device
    resolve_device("cuda")          # also pins full-f32 matmuls
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    main_recs, launches = {}, {}
    t_start = time.perf_counter()
    try:
        for p, fn in ((1, phase_build), (2, phase_kernels),
                      (3, phase_full_width), (4, phase_tiny_identity)):
            t0 = time.perf_counter()
            out = fn()
            if p == 2:
                main_recs = out
            if p == 3:
                launches = out
            log(f"[phase {p}] ok in {time.perf_counter() - t0:.1f} s")
    except Exception as e:  # report which phase failed, then exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[env] total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, info in KERNEL_INFO.items():
        r = main_recs[name]
        kernels.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
