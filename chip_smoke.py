#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # one CUDA card; no arguments

Phase 1 builds the hand-written kernels from ``src/repro_torch/kernels/
csrc`` with nvcc for sm_90a.  Phase 2 holds each kernel against its plain
PyTorch version on the card at the main path's shapes (plus GQA and
window shapes, and the edge shapes of the tile walks: S not a multiple
of 32, one needed tile, an idle slot, g up to 8, hd 16-128, 16 query rows
and S = 4096 for attn_with_importance, each dense launch logged with its
split count and grid; the paged kernels also at three split layouts;
ssd_scan at batch 1, over four chunks and at N = 64; then the shapes of
phases 8 and 9: every attention entry point at head dim 80, decode
and prefill at GQA groups g = 6 and g = 16, and every shape those
phases launch -- zamba2's C = 512 prefill, its decode over 544 slots,
each dense config's prefill buckets and decode), in float32 and
bfloat16, requires attn_with_importance and ssd_scan to give the same
bits on a second call and a slot no query may see to get importance
exactly 0, and times kernel, plain version and one library call with L2
flushed before each timed call, beside an empty kernel's time under the
same harness.  It also holds the grouped product (``grouped_mm``, the
counterpart of ``lax.ragged_dot`` in the MoE layer) at phase 10's
shapes -- qwen3-moe's decode (32 rows) and 256-token prefill (2,048
rows), llama4-maverick's (4 and 256 rows), each product direction, group
sizes from a skewed routing draw with empty groups and groups past a
128-row tile, one model rank's share with rows past the last group --
and its input and weight gradients at qwen3-moe's prefill, in both
dtypes, a second call bit-identical, timed beside
``torch._grouped_mm`` and a per-expert ``torch.matmul`` loop.  Phase 3 serves
``run_synera`` and ``run_cloud_centric`` end to end with the paper's
SLM/LLM pair at full width on the dense cache (random weights from a
seed) and checks that every kernel of the path was launched.  Phase 4
runs the tiny pair in float32 through the kernels and through the plain
attention paths -- dense, and a paged engine that shares, retains and
swaps on a small pool -- and requires identical greedy token streams.
Phase 5 serves the full-width pair again on the paged cache (prefix
sharing, retention, host swap, a pool too small for every stream) and
checks that the paged kernels ran and the pool drained.  Phase 6 frees
that pair and serves ``mamba2-2.7b`` at full width (64 layers, d_model
2560, bf16, random weights from a seed) through the model-level steps:
a batched prefill of 4 x 512 tokens, 32 greedy decode steps, a chunked
feed (256 + 256 through the verify step, the h0 path) that must agree
with the one-shot prefill, and the same prefill on the plain SSD path
(cosine >= 0.999); it checks that ``ssd_scan`` ran 64 times per
multi-token forward and that the reduced mamba2 in float32 gives
identical greedy streams through the kernel and the plain path.
Phase 7 runs between phases 5 and 6, while the full-width pair is still
loaded: a fleet of two paged replicas that share prefixes serves six
prompts (three behind one 128-token system prompt) under prefix-affinity
and round-robin, then with replica 1 killed mid-verify, and one replica
at queue cap 1 degrades streams to the device; every cloud-verified
stream must equal a one-replica oracle, and the paged prefill kernel
must run on both replicas.  It then calls the serve launcher in-process
on the tiny pair (one replica and two: one ``outputs_sha``) and streams
one chat completion through the HTTP gateway over a two-replica router
(the batch run's tokens).  Phase 8 serves the reference's other dense
configs at full width in bf16 (llama3.2-1b, qwen2-1.5b, glm4-9b, and
qwen1.5-110b at 8 of its 80 layers) with ``run_cloud_centric`` on a dense
engine, checks that the dense attention kernels ran, holds the prefill
logits against the plain attention path (cosine >= 0.999) and, at 2
layers in float32, requires identical greedy streams.  Phase 9 serves
``zamba2-2.7b`` (54 Mamba2 layers in 9 rounds, each closed by the one
weight-shared MHA block at head dim 80) at full width as phase 6 serves
mamba2, with exact launch counts for ``ssd_scan`` and both attention
kernels, identical float32 greedy streams at 2 rounds, and prefill
logits within cosine 0.999 of the plain path at one round (at full
depth the plain path's own floor is far lower, so there the cosine is
logged, beside the plain path with P rounded to bf16 as a witness).
Phase 10 serves the reference's MoE configs at published widths in bf16
-- qwen3-moe-235b-a22b at 8 of its 94 layers, llama4-maverick-400b-a17b
at one round (a dense and an MoE layer) of its 48 -- with
``run_cloud_centric`` on a dense and on a paged, prefix-sharing engine
(each path's two attention kernels launched and nothing else, no leaked
block), holds the prefill logits against the plain attention path routed
as the kernel path chose (cosine >= 0.999, after the plain floor clears
it), profiles one prefill and one decode step
(busy share, launches, host syncs, the experts' GEMM time against the
attention kernels; no host sync inside ``moe_ffn``), runs one decode
step with its MoE layers under ``torch.cuda.set_sync_debug_mode(
"error")``, and at 2
layers in float32 requires identical streams through the kernels and the
plain path, dense and paged.  Each engine also launches ``grouped_mm``,
the experts' products.  Phase 2
holds the attention kernels at the shapes phase 10 launches (g = 16 over
4 KV heads, g = 5 over 8); phase 4 also serves the tiny pair with its LLM
made MoE, dense and paged, through the kernels and the plain paths.
Phase 11 runs the reference's vlm and audio configs at published widths
in bf16 -- whisper-medium whole (24 encoder and 24 decoder layers),
llama-3.2-vision-90b at two of its 20 rounds (8 self-attention and 2
gated cross-attention layers; the gates, zero at init, set to 0.5) --
with stub audio frames and image embeds from a seeded generator, through
the model-level steps: a batched prefill with the aux inputs (filling
the cross cache), 32 greedy decode steps, and an 8-token verify chunk
that must agree with the full forward and leave the cross cache alone,
with exact launch counts (one attention kernel per causal self-attention
layer; the encoder and the cross-attention are plain); prefill logits
within cosine 0.999 of the plain path where the plain floor clears it;
``run_cloud_centric`` on a dense engine (whose steps never fill the cross
cache, as the reference serves these families); one profiled prefill and
decode step; and identical float32 greedy streams through the kernels and
the plain path at 2 + 2 layers (whisper) and one round (vision).  Phase 2
holds whisper's g = 1 over 16 heads of 64 at every shape it launches.
Phase 12 trains through the port, every earlier model freed: the paper's
160M SLM whole (``launch.train.train``, 40 steps of 16 x 512, bf16,
remat; every loss finite, the last five's mean below the first; ms a
step, tokens/s, peak memory, and over two profiled steps the busy share,
launches and an mfu from ``train_flops``; the stacked-leaf gradient
indexed per layer against one unbind), the 7B's widths at 4 of its 32
layers (5 steps of ``make_train_step`` with two micro-batches of 4 x
512: finite loss, grad_norm > 0), one train step of each family's
reduced config in float32 on the card against the host (loss, each
gradient leaf, the parameters after the update), and the tiny pair
trained with the reference prepare's settings, saved with the port's
``checkpoint.io.save`` and served from there by ``launch.serve`` (the
trained LLM's held-out nll below the SLM's).  No attention or SSD
kernel may launch while it trains, and a train step under ``attn_impl=
"pallas"`` on an attention family must raise (those kernels have no
gradient); the MoE families' steps in 12c run the grouped kernels
forward and backward (``grouped_mm``, ``grouped_mm_wgrad``).
Phase 13 runs the mesh tooling over a one-rank process group (NCCL for
the card, gloo for the host): ``moe_ffn_ep`` at qwen3-moe-235b-a22b's
published widths on a 1 x 1 ``DeviceMesh("cuda")`` (one layer, 4 x 1 and
4 x 256 tokens; float32 within 1e-4 of the same call on the host,
bfloat16 at cosine >= 0.99 of float32, 3 all-gathers and 3 all-reduces
through the group), llama3.2-1b's decode step (B 8 over 4,096 slots)
from ``dryrun.build_step`` with real weights (the counted argument bytes
are the bytes the card holds; neither roofline term above the measured
step), and one production-mesh record of the dry run (256 fake ranks,
``meta``); none of the port's kernels may launch.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without that line.  The port never imports JAX; neither does
this script.
"""
from __future__ import annotations

import gc
import hashlib
import json
import re
import signal
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
    "decode_attention_paged": dict(
        source="src/repro_torch/kernels/csrc/decode_gqa.cu",
        replaces="src/repro/kernels/decode_gqa/decode_gqa.py:207"),
    "partial_prefill_attention_paged": dict(
        source="src/repro_torch/kernels/csrc/partial_prefill.cu",
        replaces="src/repro/kernels/partial_prefill/partial_prefill.py:204"),
    "ssd_scan": dict(
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:75"),
    # lax.ragged_dot, an XLA op (no Pallas kernel) in the reference's moe_ffn
    "grouped_mm": dict(
        source="src/repro_torch/kernels/csrc/grouped_mm.cu",
        replaces="src/repro/models/layers.py:605"),
}
# the kernels each serving path launches (phases 3, 5 and 6)
DENSE_PATH = ("decode_attention", "partial_prefill_attention",
              "attn_with_importance")
PAGED_PATH = ("decode_attention_paged", "partial_prefill_attention_paged")
SSM_PATH = ("ssd_scan",)
MOE_PATH = ("grouped_mm",)      # the experts' products (phases 4, 10, 12c)
GROUPED = ("grouped_mm", "grouped_mm_wgrad")
# CUDA symbols of the port's kernels (profiler rows): the attention
# kernels, and the four passes of one ssd_scan call
PORT_KERNEL_SYMBOLS = ("decode_gqa_kernel", "partial_prefill_kernel",
                       "attn_importance_kernel", "combine_splits_kernel")
SSD_KERNEL_SYMBOLS = ("ssd_prep_kernel", "ssd_state_kernel",
                      "ssd_carry_kernel", "ssd_output_kernel")


def log(*a):
    print(*a, flush=True)


def kernel_modules():
    from repro_torch.kernels import (attn_importance, decode_gqa,
                                     grouped_mm, partial_prefill, ssd_scan)
    return {"decode_attention": decode_gqa,
            "partial_prefill_attention": partial_prefill,
            "attn_with_importance": attn_importance,
            "decode_attention_paged": decode_gqa,
            "partial_prefill_attention_paged": partial_prefill,
            "ssd_scan": ssd_scan,
            "grouped_mm": grouped_mm,
            "grouped_mm_wgrad": grouped_mm}


def _counter(name: str) -> str:
    """Name of the launch counter of kernel ``name`` in its module."""
    for suffix in ("paged", "wgrad"):
        if name.endswith("_" + suffix):
            return f"{suffix}_launches"
    return "launches"


def reset_launches():
    for name, mod in kernel_modules().items():
        setattr(mod, _counter(name), 0)


def read_launches():
    return {name: getattr(mod, _counter(name))
            for name, mod in kernel_modules().items()}


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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
HOLD_CYCLES = 1_000_000          # ~0.5 ms of device sleep before each call


def _time_ms(fn, iters=20, warmup=3, cold=True):
    """Mean ms of one call of ``fn`` (CUDA events around each call).  With
    ``cold`` a 256 MB buffer is written before every timed call, so the
    call finds none of its inputs in L2 -- as on the main path, where the
    other layers' K/V and the weights pass through L2 between two uses of
    one layer's cache.  The device sleeps before each call while the host
    queues it, so the events time the device's work, not the host's
    enqueue (which is longer than a kernel of a few tens of us)."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        torch.cuda._sleep(HOLD_CYCLES)
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


def case_positions(name, shape, opts, rng):
    """Positions of one dense kernel case, numpy int32: (q_pos, kv_pos).
    ``opts``: ``idle`` makes slot 1 idle (q_pos -1: a decode slot with no
    query, a chunk of padded rows); ``full`` gives every slot all C query
    rows (no padded rows, as the model-level prefill and feed steps call
    the kernel); the window is the kernel's argument."""
    if name == "decode_attention":
        B, S, nh, nkv, hd, lo, hi = shape
        qp, kp = _cache_positions(rng, B, S, 1, lo, hi, pad_rows=False)
        qp = qp[:, 0].copy()
    else:
        B, C, S, nh, nkv, hd, lo, hi = shape
        qp, kp = _cache_positions(
            rng, B, S, C, lo, hi,
            pad_rows=name != "attn_with_importance" and not opts.get("full"))
    if opts.get("idle"):
        qp[1] = -1
    return qp, kp


def _case(name, shape, dtype, seed, opts=None):
    """Inputs for one kernel check, on the card."""
    import torch
    dev = "cuda"
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev).to(dtype)

    qp, kp = case_positions(name, shape, opts or {}, rng)
    if name == "decode_attention":
        B, S, nh, nkv, hd, lo, hi = shape
        q = randn(B, nh, hd)
    else:
        B, C, S, nh, nkv, hd, lo, hi = shape
        q = randn(B, C, nh, hd)
    return dict(q=q, k=randn(B, S, nkv, hd), v=randn(B, S, nkv, hd),
                q_pos=torch.from_numpy(qp).to(dev),
                kv_pos=torch.from_numpy(kp).to(dev))


def _valid(name, a, window=0):
    kp, qp = a["kv_pos"], a["q_pos"]
    if name == "decode_attention":
        qp = qp[:, None]
    valid = (kp[:, None, :] >= 0) & (qp[:, :, None] >= 0) \
        & (kp[:, None, :] <= qp[:, :, None])
    if window:
        valid &= (qp[:, :, None] - kp[:, None, :]) < window
    return valid


def _library_call(name, a, window=0):
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
    mask = _valid(name, a, window)[:, None]
    gqa = qt.shape[1] != kt.shape[1]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)


# (kernel, label, shape, main-path?, options)  Shapes: decode (B, S, nh,
# nkv, hd, fill lo, fill hi); others (B, C, S, nh, nkv, hd, fill lo, fill
# hi).  The fills match phase 3: prompts of 64-256 tokens plus 32
# generated.  After the serving shapes come the edge shapes of the
# kernels' needed-tile walk (and the dense kernels' split-KV layout): S
# not a multiple of 32, one needed tile, an idle slot (q_pos -1), a
# window, g in {1, 2, 4, 8}, hd in {16, 32, 64, 128}, and for
# attn_with_importance 16 query rows and S = 4096.  Then the shapes of
# phases 8 and 9: hd 80 with nh = nkv = 32 (zamba2's shared block: decode
# over a full 1024-slot cache, a verify chunk, the chunked feed's 256-row
# chunk, the importance kernel with an idle slot), and the GQA groups of
# the dense configs at their serving shapes (4 slots, s_max 512): g = 6
# (qwen2-1.5b, nh 12 / nkv 2) and g = 16 (glm4-9b, nh 32 / nkv 2), hd 128.
# Last, the shapes phases 8 and 9 launch that the cases above miss: phase
# 9's one-shot prefill (C = 512 over its 544-slot cache), its decode
# steps (positions 512-543 of that cache) and the chunked feed's first
# half, all rows filled as the model-level steps fill them; and each
# phase-8 config's prefill buckets (C = 64, 128, 256: prompts of 64-256
# tokens from position 0, the tail rows padded) and decode over its
# 512-slot cache.  Then the GQA groups of phase 10's MoE configs, hd 128:
# g = 16 over nkv 4 (qwen3-moe, nh 64) and g = 5 over nkv 8
# (llama4-maverick, nh 40; its g C packed rows fill no whole number of
# 16-row tiles at C = 8): decode over the 512-slot cache, each prefill
# bucket from position 0, and a C = 8 verify chunk over a cached prefix.
# Then phase 11's: whisper-medium's MHA decoder (g = 1 over 16 heads of
# 64) at the engine's decode over its 512-slot cache and its prefill
# buckets, and for whisper and llama-3.2-vision-90b's self layers (g = 8,
# hd 128; its engine shapes are qwen1.5-110b's) the model-level prefill
# of 248 tokens, the C = 8 verify chunk over them and the uncached full
# forward over 256 tokens, all rows filled.
# Options: ``window`` (the kernel's argument), ``idle`` (slot 1 has no
# query), ``full`` (no padded query rows).
KERNEL_CASES = [
    ("decode_attention", "cloud decode", (8, 2048, 32, 32, 128, 64, 320), True,
     {}),
    ("decode_attention", "gqa g=4", (4, 1024, 32, 8, 128, 64, 900), False,
     {}),
    ("partial_prefill_attention", "cloud verify C=32",
     (8, 32, 2048, 32, 32, 128, 64, 288), True, {}),
    ("partial_prefill_attention", "cloud prefill C=256",
     (8, 256, 2048, 32, 32, 128, 0, 1), False, {}),
    ("partial_prefill_attention", "device prompt feed",
     (1, 127, 512, 12, 12, 64, 0, 1), False, {}),
    ("partial_prefill_attention", "gqa g=4", (2, 16, 512, 16, 4, 64, 32, 400),
     False, {}),
    ("attn_with_importance", "device draft", (1, 1, 512, 12, 12, 64, 64, 288),
     True, {}),
    ("attn_with_importance", "gqa g=4", (2, 8, 256, 8, 2, 64, 32, 200), False,
     {}),
    ("attn_with_importance", "S=1000 g=2", (2, 1, 1000, 8, 4, 64, 100, 990),
     False, {}),
    ("attn_with_importance", "idle slot", (4, 1, 512, 12, 12, 64, 64, 288),
     False, {"idle": True}),
    ("attn_with_importance", "Tq=16 g=8 hd=128",
     (2, 16, 512, 16, 2, 128, 32, 400), False, {}),
    ("attn_with_importance", "S=4096 hd=32", (2, 1, 4096, 8, 8, 32, 1000, 4000),
     False, {}),
    ("attn_with_importance", "one needed tile", (4, 1, 512, 12, 12, 64, 0, 20),
     False, {}),
    ("decode_attention", "S=1000 g=2", (4, 1000, 16, 8, 64, 100, 990), False,
     {}),
    ("decode_attention", "one needed tile", (4, 512, 8, 8, 32, 0, 20), False,
     {}),
    ("decode_attention", "idle slot g=8", (4, 256, 8, 1, 16, 32, 200), False,
     {"idle": True}),
    ("decode_attention", "window 64 g=8", (4, 1024, 32, 4, 128, 200, 1000),
     False, {"window": 64}),
    ("partial_prefill_attention", "S=1000 g=2",
     (2, 24, 1000, 16, 8, 64, 100, 950), False, {}),
    ("partial_prefill_attention", "one needed tile",
     (4, 8, 512, 8, 8, 32, 0, 16), False, {}),
    ("partial_prefill_attention", "idle slot g=8",
     (4, 16, 256, 8, 1, 16, 32, 200), False, {"idle": True}),
    ("partial_prefill_attention", "window 64 g=8",
     (2, 32, 1024, 32, 4, 128, 200, 900), False, {"window": 64}),
    ("decode_attention", "zamba2 decode hd=80",
     (4, 1024, 32, 32, 80, 1000, 1023), False, {}),
    ("partial_prefill_attention", "zamba2 verify C=32 hd=80",
     (4, 32, 1024, 32, 32, 80, 480, 992), False, {}),
    ("partial_prefill_attention", "zamba2 feed C=256 hd=80",
     (4, 256, 512, 32, 32, 80, 256, 257), False, {}),
    ("attn_with_importance", "zamba2 hd=80", (1, 1, 512, 32, 32, 80, 64, 288),
     False, {}),
    ("attn_with_importance", "idle slot hd=80",
     (4, 1, 512, 32, 32, 80, 64, 288), False, {"idle": True}),
    ("decode_attention", "qwen2-1.5b g=6", (4, 512, 12, 2, 128, 64, 272),
     False, {}),
    ("partial_prefill_attention", "qwen2-1.5b prefill C=256 g=6",
     (4, 256, 512, 12, 2, 128, 0, 1), False, {}),
    ("decode_attention", "glm4-9b g=16", (4, 512, 32, 2, 128, 64, 272),
     False, {}),
    ("partial_prefill_attention", "glm4-9b prefill C=256 g=16",
     (4, 256, 512, 32, 2, 128, 0, 1), False, {}),
    ("partial_prefill_attention", "zamba2 prefill C=512 S=544 hd=80",
     (4, 512, 544, 32, 32, 80, 0, 1), False, {"full": True}),
    ("decode_attention", "zamba2 decode S=544 hd=80",
     (4, 544, 32, 32, 80, 512, 544), False, {}),
    ("partial_prefill_attention", "zamba2 feed first half C=256 hd=80",
     (4, 256, 512, 32, 32, 80, 0, 1), False, {"full": True}),
] + [
    ("partial_prefill_attention", f"{cfg} prefill C={c} g={nh // nkv}",
     (4, c, 512, nh, nkv, hd, 0, 1), False, {})
    for cfg, nh, nkv, hd, buckets in (
        ("llama3.2-1b", 32, 8, 64, (64, 128, 256)),
        ("qwen2-1.5b", 12, 2, 128, (64, 128)),
        ("glm4-9b", 32, 2, 128, (64, 128)),
        ("qwen1.5-110b", 64, 8, 128, (64, 128, 256)))
    for c in buckets
] + [
    ("decode_attention", f"{cfg} decode g={nh // nkv}",
     (4, 512, nh, nkv, hd, 64, 272), False, {})
    for cfg, nh, nkv, hd in (("llama3.2-1b", 32, 8, 64),
                             ("qwen1.5-110b", 64, 8, 128))
] + [
    case
    for cfg, nh, nkv in (("qwen3-moe", 64, 4), ("llama4-maverick", 40, 8))
    for case in (
        [("decode_attention", f"{cfg} decode g={nh // nkv}",
          (4, 512, nh, nkv, 128, 64, 272), False, {}),
         ("partial_prefill_attention", f"{cfg} verify C=8 g={nh // nkv}",
          (4, 8, 512, nh, nkv, 128, 64, 272), False, {})]
        + [("partial_prefill_attention", f"{cfg} prefill C={c} g={nh // nkv}",
            (4, c, 512, nh, nkv, 128, 0, 1), False, {})
           for c in (64, 128, 256)])
] + [
    ("decode_attention", "whisper decode g=1", (4, 512, 16, 16, 64, 64, 272),
     False, {})
] + [
    ("partial_prefill_attention", f"whisper prefill C={c} g=1",
     (4, c, 512, 16, 16, 64, 0, 1), False, {})
    for c in (64, 128, 256)
] + [
    case
    for cfg, nh, nkv, hd in (("whisper", 16, 16, 64),
                             ("llama-3.2-vision", 64, 8, 128))
    for case in (
        ("partial_prefill_attention", f"{cfg} prefill C=248 g={nh // nkv}",
         (4, 248, 512, nh, nkv, hd, 0, 1), False, {"full": True}),
        ("partial_prefill_attention", f"{cfg} verify C=8 g={nh // nkv}",
         (4, 8, 512, nh, nkv, hd, 248, 249), False, {"full": True}),
        ("partial_prefill_attention",
         f"{cfg} forward C=256 S=256 g={nh // nkv}",
         (4, 256, 256, nh, nkv, hd, 0, 1), False, {"full": True}))
]


def dense_launch(name, shape):
    """Split count, grid and threads of a dense kernel's launch at
    ``shape`` on this card (kernels/splits.py, as the wrapper computes
    it)."""
    import torch
    from repro_torch.kernels import splits as SP
    if name == "decode_attention":
        B, S, nh, nkv = shape[:4]
        rows, decode = nh // nkv, True
    else:
        B, C, S, nh, nkv = shape[:5]
        rows, decode = nh // nkv * C, False
    return SP.dense_grid(B, nkv, rows, S, decode=decode,
                         sms=SP.sm_count(torch.device("cuda")))


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
    for i, (name, label, shape, is_main, opts) in enumerate(KERNEL_CASES):
        window = opts.get("window", 0)
        kw = dict(window=window) if window else {}
        for dtype in (torch.float32, torch.bfloat16):
            a = _case(name, shape, dtype, seed=100 + i, opts=opts)
            kern = getattr(mods[name], name)
            out_k = kern(**a, **kw)
            out_p = plain[name](**a, **kw)
            torch.cuda.synchronize()
            atol, rtol = TOL[str(dtype)]
            valid = _valid(name, a, window)
            if name == "attn_with_importance":
                (ok_, ik), (op, ip) = out_k, out_p
                again = kern(**a, **kw)
                # a slot no row may see has importance exactly 0, and a
                # second call gives the same bits (imp feeds thresholds)
                masked = ~valid.any(dim=1)[:, None].expand_as(ik)
                good = (_close(ok_, op, atol, rtol)
                        and _close(ik, ip, IMP_ATOL, 0.0)
                        and bool((ik[masked] == 0).all())
                        and torch.equal(again[0], ok_)
                        and torch.equal(again[1], ik))
                err = max(float((ok_.float() - op.float()).abs().max()),
                          float((ik - ip).abs().max()))
                out_bytes = ok_.numel() * ok_.element_size() + ik.numel() * 4
            else:
                good = _close(out_k, out_p, atol, rtol)
                err = float((out_k.float() - out_p.float()).abs().max())
                out_bytes = out_k.numel() * out_k.element_size()
                # padded rows and idle slots come out exactly 0
                pad = a["q_pos"] < 0
                good = good and bool((out_k[pad] == 0).all())
            nh, hd = a["q"].shape[-2], a["q"].shape[-1]
            pos_bytes = (a["q_pos"].numel() + a["kv_pos"].numel()) * 4
            nbytes, flops = _bytes_flops(a["q"], a["k"], out_bytes, valid,
                                         nh, hd, extra_bytes=pos_bytes)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / PEAK_FLOPS[str(dtype)] * 1e3
            ms = _time_ms(lambda: kern(**a, **kw))
            warm_ms = _time_ms(lambda: kern(**a, **kw), cold=False)
            plain_ms = _time_ms(lambda: plain[name](**a, **kw), iters=5)
            lib = _library_call(name, a, window)
            lib_ms = _time_ms(lib) if lib is not None else None
            launch = ({} if name == "attn_with_importance"
                      else dense_launch(name, shape))
            rec = dict(name=name, case=label, dtype=str(dtype),
                       shape=list(shape), **opts, **launch, ok=good,
                       max_abs_err=err, ms=ms,
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
    # the floor under any of these times: one kernel that does nothing
    # (a zero-cycle sleep), timed by the same harness
    floor = _time_ms(lambda: torch.cuda._sleep(0))
    log(f"[kernels] empty kernel under _time_ms (launch floor): {floor} ms")
    main["attn_with_importance"]["empty_kernel_ms"] = floor
    phase_slot_index()
    main.update(phase_paged_kernels())
    main.update(phase_ssd_kernel())
    main.update(phase_grouped_mm())
    return main


# The slot-indexed partial_prefill (kernel table row 2i) at the chat
# cells' compacted prefills: B real slots of a 32-slot cache whose other
# slots hold served streams (64-1,000 keys), each slot's prompt from
# position 0 filling half to all of the bucket C, S 2,048.  Beside it the
# unindexed launch over the gathered rows, which it must equal bit for bit,
# and the full-width launch an uncompacted prefill makes (32 query slots,
# B of them real).  The first call at each new (B, C) is timed on the
# host, to the end of the work, against the steady call.
SLOT_HEADS = (("qwen1.5-7b", 32, 32), ("qwen3-moe", 64, 4))   # hd 128
SLOT_B = (1, 2, 4)
SLOT_C = (64, 128, 256)
SLOT_CACHE = (32, 2048)


def _host_ms(fn, iters=1):
    """Mean host ms of ``fn`` to the end of its device work."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_slot_index():
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import partial_prefill as PP
    build.library("partial_prefill")    # loaded once, before any timing
    name = "partial_prefill_attention"
    n_cache, S = SLOT_CACHE
    hd, bf16 = 128, torch.bfloat16
    atol, rtol = TOL[str(bf16)]
    ok = True
    for h, (cfg, nh, nkv) in enumerate(SLOT_HEADS):
        rng = np.random.default_rng(300 + h)
        gen = torch.Generator(device="cuda").manual_seed(300 + h)

        def randn(*s):
            return torch.randn(*s, generator=gen, device="cuda").to(bf16)

        k, v = randn(n_cache, S, nkv, hd), randn(n_cache, S, nkv, hd)
        served = np.full((n_cache, S), -1, np.int32)
        for b in range(n_cache):
            n = int(rng.integers(64, 1000))
            served[b, :n] = np.arange(n)
        for B in SLOT_B:
            slots = np.sort(rng.choice(n_cache, B, replace=False))
            for C in SLOT_C:
                kp = served.copy()
                qp = np.full((B, C), -1, np.int32)
                for i, b in enumerate(slots):
                    nq = int(rng.integers(C // 2 + 1, C + 1))
                    kp[b] = -1
                    kp[b, :nq] = np.arange(nq)
                    qp[i, :nq] = np.arange(nq)
                q = randn(B, C, nh, hd)
                st = torch.from_numpy(slots.astype(np.int32)).cuda()
                qpt = torch.from_numpy(qp).cuda()
                kpt = torch.from_numpy(kp).cuda()
                gl = st.long()
                g = dict(q=q, k=k[gl].contiguous(), v=v[gl].contiguous(),
                         q_pos=qpt, kv_pos=kpt[gl].contiguous())
                qf = torch.zeros(n_cache, C, nh, hd, dtype=bf16,
                                 device="cuda")
                qf[gl] = q
                qpf = torch.full((n_cache, C), -1, dtype=torch.int32,
                                 device="cuda")
                qpf[gl] = qpt

                def indexed():
                    return PP.partial_prefill_attention(q, k, v, qpt, kpt,
                                                        slots=st)

                def full():
                    return PP.partial_prefill_attention(qf, k, v, qpf, kpt)

                first_ms = _host_ms(indexed)
                steady_ms = _host_ms(indexed, iters=20)
                out = indexed()
                out_g = PP.partial_prefill_attention(**g)
                out_f = full()
                ref = PP.partial_prefill_ref(q, k, v, qpt, kpt, slots=st)
                torch.cuda.synchronize()
                good = (torch.equal(out, out_g)
                        and _close(out, ref, atol, rtol)
                        and _close(out_f[gl], ref, atol, rtol)
                        and bool((out[qpt < 0] == 0).all()))
                valid = _valid(name, g)
                nbytes, flops = _bytes_flops(
                    q, g["k"], out.numel() * out.element_size(), valid, nh,
                    hd, extra_bytes=(qpt.numel() + g["kv_pos"].numel()
                                     + B) * 4)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_flops = flops / PEAK_FLOPS[str(bf16)] * 1e3
                lib = _library_call(name, g)
                rec = dict(
                    name=name, case=f"{cfg} slots {B} of {n_cache} C={C}",
                    dtype=str(bf16), shape=[B, C, S, nh, nkv, hd],
                    slots=slots.tolist(),
                    launch=dense_launch(name, (B, C, S, nh, nkv)),
                    full_launch=dense_launch(name, (n_cache, C, S, nh, nkv)),
                    ok=good,
                    max_abs_err=float((out.float() - ref.float()).abs()
                                      .max()),
                    ms=_time_ms(indexed),
                    ms_l2_warm=_time_ms(indexed, cold=False),
                    gathered_ms=_time_ms(
                        lambda: PP.partial_prefill_attention(**g)),
                    full_width_ms=_time_ms(full),
                    first_call_host_ms=first_ms,
                    steady_host_ms=steady_ms,
                    plain_ms=_time_ms(lambda: PP.partial_prefill_ref(
                        q, k, v, qpt, kpt, slots=st), iters=5),
                    library_ms=_time_ms(lib),
                    bound_ms=max(t_bytes, t_flops),
                    bound_by="bytes" if t_bytes >= t_flops else
                    "operations")
                log("[kernels 2i] " + json.dumps(rec))
                ok = ok and good
        del k, v
    if not ok:
        raise RuntimeError("the slot-indexed partial_prefill disagrees with "
                           "the gathered rows or its plain version")


# Paged kernels.  Shapes: (B, C, nh, nkv, hd, block size, max_bps, pool
# blocks, fill lo, fill hi, window); C = 1 is decode.  Each slot's table
# maps a ragged run of a random permutation of pool blocks (-1 tail), and
# holds ~300 tokens as phase 5's streams do.  Split layouts (block_kv,
# kv_splits): one-block steps, fused steps, fused + four splits (three of
# them empty at this fill, so the merge sees empty splits).
PAGED_VARIANTS = [(None, 1), (128, 1), (128, 4)]
PAGED_MAIN = (128, 1)            # phase 5's CloudEngine(paged_block_kv, kv_splits)
PAGED_CASES = [
    ("decode_attention_paged", "cloud decode",
     (8, 1, 32, 32, 128, 16, 128, 1024, 280, 320, 0), PAGED_VARIANTS, True),
    ("partial_prefill_attention_paged", "cloud verify C=32",
     (8, 32, 32, 32, 128, 16, 128, 1024, 280, 320, 0), PAGED_VARIANTS, True),
    ("partial_prefill_attention_paged", "cloud prefill C=256",
     (8, 256, 32, 32, 128, 16, 128, 1024, 280, 320, 0), PAGED_VARIANTS,
     False),
    ("decode_attention_paged", "gqa g=4",
     (4, 1, 32, 8, 128, 16, 128, 1024, 280, 320, 0), [(128, 1), (128, 4)],
     False),
    ("partial_prefill_attention_paged", "gqa g=4",
     (4, 16, 32, 8, 128, 16, 128, 1024, 280, 320, 0), [(128, 4)], False),
    ("decode_attention_paged", "window 64",
     (8, 1, 32, 32, 128, 16, 128, 1024, 280, 320, 64), [(128, 4)], False),
    ("partial_prefill_attention_paged", "window 64",
     (8, 32, 32, 32, 128, 16, 128, 1024, 280, 320, 64), [(128, 4)], False),
    # hd 80 (no path runs the paged instances at 80 -- the hybrid cannot
    # be paged -- but the wrappers take it)
    ("decode_attention_paged", "hd=80",
     (4, 1, 32, 32, 80, 16, 64, 512, 280, 320, 0), [(128, 1), (128, 4)],
     False),
    ("partial_prefill_attention_paged", "hd=80",
     (4, 32, 32, 32, 80, 16, 64, 512, 280, 320, 0), [(128, 1), (128, 4)],
     False),
] + [
    # phase 10's paged engines (4 slots, s_max 512 in 16-token blocks, the
    # default 128-block pool and layout) at the MoE configs' groups
    (name, f"{cfg} {label} g={nh // nkv}",
     (4, c, nh, nkv, 128, 16, 32, 128, 64, 272, 0), [PAGED_MAIN], False)
    for cfg, nh, nkv in (("qwen3-moe", 64, 4), ("llama4-maverick", 40, 8))
    for name, label, c in (("decode_attention_paged", "decode", 1),
                           ("partial_prefill_attention_paged", "verify C=8",
                            8),
                           ("partial_prefill_attention_paged", "chunk C=64",
                            64))
]


def _paged_case(name, shape, dtype, seed):
    """Inputs for one paged kernel check, on the card."""
    import torch
    dev = "cuda"
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    B, C, nh, nkv, hd, bs, mbps, nb, lo, hi, window = shape

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev).to(dtype)

    pos = np.full((nb, bs), -1, np.int32)
    bt = np.full((B, mbps), -1, np.int32)
    qp = np.full((B, C), -1, np.int32)
    perm = iter(rng.permutation(nb))
    for b in range(B):
        L = int(rng.integers(lo, hi))            # tokens in the pool
        for j in range(-(-L // bs)):
            blk = next(perm)
            bt[b, j] = blk
            n = min(bs, L - j * bs)
            pos[blk, :n] = j * bs + np.arange(n)
        nq = C if C in (1, 256) else int(rng.integers(1, C + 1))
        qp[b, :nq] = L - nq + np.arange(nq)      # write-then-attend tail
    a = dict(k_pool=randn(nb, bs, nkv, hd), v_pool=randn(nb, bs, nkv, hd),
             pos_pool=torch.from_numpy(pos).to(dev),
             block_tables=torch.from_numpy(bt).to(dev))
    if name == "decode_attention_paged":
        a.update(q=randn(B, nh, hd), q_pos=torch.from_numpy(qp[:, 0]).to(dev))
    else:
        a.update(q=randn(B, C, nh, hd), q_pos=torch.from_numpy(qp).to(dev))
    return a, window


def phase_paged_kernels():
    """Each paged kernel against its plain version, at every split layout
    of its cases; times kernel (L2 cold and warm), plain version and, as a
    yardstick, the dense kernel on the same data gathered into a dense
    cache (gather excluded).  No single PyTorch call reads a block table,
    so the library time is none.  Returns the bf16 main-path records."""
    import torch
    from repro_torch.models import layers as L
    mods = kernel_modules()
    plain = {"decode_attention_paged":
             mods["decode_attention_paged"].decode_attention_paged_ref,
             "partial_prefill_attention_paged":
             mods["partial_prefill_attention_paged"].partial_prefill_paged_ref}
    dense = {"decode_attention_paged":
             mods["decode_attention"].decode_attention,
             "partial_prefill_attention_paged":
             mods["partial_prefill_attention"].partial_prefill_attention}
    main, ok = {}, True
    for i, (name, label, shape, variants, is_main) in enumerate(PAGED_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            a, window = _paged_case(name, shape, dtype, seed=200 + i)
            kd, vd, posd = L.paged_kv_view(
                {"k": a["k_pool"], "v": a["v_pool"], "pos": a["pos_pool"],
                 "block_tables": a["block_tables"]})
            qd = a["q"]
            dense_args = dict(q=qd, k=kd, v=vd, q_pos=a["q_pos"],
                              kv_pos=posd, window=window)
            valid = _valid(name.replace("_paged", ""),
                           dict(kv_pos=posd, q_pos=a["q_pos"]))
            if window:
                qq = (a["q_pos"][:, None] if name.startswith("decode")
                      else a["q_pos"])
                valid = valid & ((qq[:, :, None] - posd[:, None, :])
                                 < window)
            n_mapped = int((a["block_tables"] >= 0).sum())
            bs = a["pos_pool"].shape[1]
            for blkv, splits in variants:
                kw = dict(window=window, block_kv=blkv, kv_splits=splits)
                kern = getattr(mods[name], name)
                out_k = kern(**a, **kw)
                out_p = plain[name](**a, **kw)
                torch.cuda.synchronize()
                atol, rtol = TOL[str(dtype)]
                good = _close(out_k, out_p, atol, rtol)
                pad = (a["q_pos"] < 0)
                if not name.startswith("decode"):
                    good = good and bool((out_k[pad] == 0).all())
                err = float((out_k.float() - out_p.float()).abs().max())
                nh, hd = qd.shape[-2], qd.shape[-1]
                extra = ((a["q_pos"].numel() + a["block_tables"].numel()
                          + n_mapped * bs) * 4)
                nbytes, flops = _bytes_flops(
                    qd, a["k_pool"], out_k.numel() * out_k.element_size(),
                    valid, nh, hd, extra_bytes=extra)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_flops = flops / PEAK_FLOPS[str(dtype)] * 1e3
                rec = dict(
                    name=name, case=label, dtype=str(dtype),
                    shape=list(shape), block_kv=blkv, kv_splits=splits,
                    ok=good, max_abs_err=err,
                    ms=_time_ms(lambda: kern(**a, **kw)),
                    ms_l2_warm=_time_ms(lambda: kern(**a, **kw), cold=False),
                    plain_ms=_time_ms(lambda: plain[name](**a, **kw),
                                      iters=5),
                    dense_kernel_ms=_time_ms(
                        lambda: dense[name](**dense_args)),
                    library_ms=None, bound_ms=max(t_bytes, t_flops),
                    bound_by="bytes" if t_bytes >= t_flops else
                    "operations")
                log("[kernels] " + json.dumps(rec))
                ok = ok and good
                if (is_main and dtype == torch.bfloat16
                        and (blkv, splits) == PAGED_MAIN):
                    main[name] = rec
    if not ok:
        raise RuntimeError("a paged kernel disagrees with its plain version")
    return main


# SSD scan.  Shapes: (B, L, H, P, N, chunk, h0?).  mamba2-2.7b's widths;
# B 4 and L 512 as phase 6's prefill, which passes the (zero) cache state
# as h0; L 300 is not a multiple of the chunk; batch 1 (80 heads x 2
# chunks of blocks); L 1024 carries the state through four chunks; N 64
# is zamba2's state width.
SSD_CASES = [
    ("prefill, h0", (4, 512, 80, 64, 128, 256, True), True),
    ("no h0", (4, 512, 80, 64, 128, 256, False), False),
    ("L=300, h0", (4, 300, 80, 64, 128, 256, True), False),
    ("B=1, h0", (1, 512, 80, 64, 128, 256, True), False),
    ("L=1024, no h0", (2, 1024, 80, 64, 128, 256, False), False),
    ("N=64, h0", (4, 512, 80, 64, 64, 256, True), False),
]


def _ssd_case(shape, dtype, seed):
    """Inputs for one ssd_scan check, on the card: the reference kernel
    test's distribution (tests/test_kernels.py)."""
    import torch
    from repro_torch.models.layers import softplus
    B, L, H, P, N, chunk, use_h0 = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g, device="cuda")

    return dict(x=(randn(B, L, H, P) * 0.5).to(dtype),
                dt=softplus(randn(B, L, H)),
                A=-torch.exp(randn(H) * 0.3),
                Bm=(randn(B, L, N) * 0.5).to(dtype),
                Cm=(randn(B, L, N) * 0.5).to(dtype),
                h0=randn(B, H, P, N) * 0.2 if use_h0 else None,
                chunk=chunk)


def _ssd_bytes_flops(a):
    """Least bytes (inputs read once, outputs written once) and flops of
    one ssd_scan call: per chunk of r rows, C B^T over the r(r+1)/2
    causal pairs once per batch row (it is shared by all heads), and per
    head M x over those pairs, C h^T (where h is not zero) and the state
    update x^T (B o w)."""
    x, Bm = a["x"], a["Bm"]
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(a["chunk"], L)
    esz = x.element_size()
    nbytes = (2 * x.numel() * esz + 2 * Bm.numel() * esz
              + (a["dt"].numel() + H + B * H * P * N) * 4
              + (a["h0"].numel() * 4 if a["h0"] is not None else 0))
    flops = 0
    for c0 in range(0, L, Q):
        r = min(Q, L - c0)
        pairs = r * (r + 1) // 2
        inter = 2 * r * N * P if (c0 or a["h0"] is not None) else 0
        flops += B * (2 * pairs * N
                      + H * (2 * pairs * P + inter + 2 * r * N * P))
    return nbytes, flops


def phase_ssd_kernel():
    """ssd_scan against its plain version on the card (y at TOL, h_final
    at 10 x TOL, as tests/test_kernels.py holds the Pallas kernel; a
    second call must give the same bits); times kernel (L2 cold and warm)
    and plain version.  No PyTorch call
    computes an SSD scan, so the library time is none.  Returns the bf16
    main-path record."""
    import torch
    from repro_torch.kernels import ssd_scan as SS
    main, ok = {}, True
    for i, (label, shape, is_main) in enumerate(SSD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            a = _ssd_case(shape, dtype, seed=300 + i)
            yk, hk = SS.ssd_scan(**a)
            yp, hp = SS.ssd_scan_ref(**a)
            y2, h2 = SS.ssd_scan(**a)
            torch.cuda.synchronize()
            atol, rtol = TOL[str(dtype)]
            good = (_close(yk, yp, atol, rtol)
                    and _close(hk, hp, 10 * atol, 10 * rtol)
                    and bool(torch.isfinite(yk.float()).all())
                    and torch.equal(y2, yk) and torch.equal(h2, hk))
            nbytes, flops = _ssd_bytes_flops(a)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / PEAK_FLOPS[str(dtype)] * 1e3
            rec = dict(
                name="ssd_scan", case=label, dtype=str(dtype),
                shape=list(shape), ok=good,
                max_abs_err=float((yk.float() - yp.float()).abs().max()),
                h_max_abs_err=float((hk - hp).abs().max()),
                ms=_time_ms(lambda: SS.ssd_scan(**a)),
                ms_l2_warm=_time_ms(lambda: SS.ssd_scan(**a), cold=False),
                plain_ms=_time_ms(lambda: SS.ssd_scan_ref(**a), iters=5),
                library_ms=None, bytes=nbytes, flops=flops,
                bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations")
            log("[kernels] " + json.dumps(rec))
            ok = ok and good
            if is_main and dtype == torch.bfloat16:
                main["ssd_scan"] = rec
    if not ok:
        raise RuntimeError("ssd_scan disagrees with its plain version")
    return main


# Grouped products: (label, experts, top-k, rows M, K, N, op, main-path?).
# op "fwd" is grouped_mm (y = x w[e]); "dx" the input gradient's product
# (dy w[e]^T, w read transposed); "wgrad" grouped_mm_wgrad (x^T dy per
# group).  Phase 10's shapes: qwen3-moe (128 experts, d 4096, d_ff 1536,
# top-8) at a decode step of its 4 slots (32 rows) and a 256-token
# prefill (2,048 rows), llama4-maverick (128 experts, d 5120, d_ff 8192,
# top-1) at 4 and 256 rows, each in both product directions; the
# backward products at qwen3-moe's prefill; and the engine's bucketed
# prefill as phase 10 profiles it: 4 slots x 256, three of them padding,
# whose 768 identical tokens all take the same 8 experts (GMM_PADDED).
# Appended later (earlier cases keep their seeds): the decode as rank 1
# of a 2-rank model axis sees it (GMM_RANKS: 64 experts, the other
# rank's rows past ends[-1]), and the down product's weight gradient.
GMM_CASES = [
    ("qwen3-moe decode, gate/up", 128, 8, 32, 4096, 1536, "fwd", True),
    ("qwen3-moe decode, down", 128, 8, 32, 1536, 4096, "fwd", False),
    ("qwen3-moe prefill 256, gate/up", 128, 8, 2048, 4096, 1536, "fwd",
     False),
    ("qwen3-moe prefill 256, down", 128, 8, 2048, 1536, 4096, "fwd", False),
    ("llama4 decode, gate/up", 128, 1, 4, 5120, 8192, "fwd", False),
    ("llama4 decode, down", 128, 1, 4, 8192, 5120, "fwd", False),
    ("llama4 prefill 256, gate/up", 128, 1, 256, 5120, 8192, "fwd", False),
    ("llama4 prefill 256, down", 128, 1, 256, 8192, 5120, "fwd", False),
    ("qwen3-moe prefill 256, gate/up dx", 128, 8, 2048, 4096, 1536, "dx",
     False),
    ("qwen3-moe prefill 256, gate/up wgrad", 128, 8, 2048, 4096, 1536,
     "wgrad", False),
    ("qwen3-moe prefill 4 x 256, 3 slots padding, gate/up", 128, 8, 8192,
     4096, 1536, "fwd", False),
    ("qwen3-moe decode, gate/up, model rank 1 of 2", 128, 8, 32, 4096, 1536,
     "fwd", False),
    ("qwen3-moe prefill 256, down wgrad", 128, 8, 2048, 1536, 4096, "wgrad",
     False),
]
GMM_PADDED = {8192: 768}         # rows M -> padding tokens among them
GMM_SKEW = 2.0                   # std of the experts' logit bias in the draw
# Cases drawn for one rank of a model axis, as _moe_ffn_sharded runs them:
# the rank's E / ranks experts keep their groups, and every assignment to
# another rank's experts is sorted past ends[-1] (rows the product zeros).
GMM_RANKS = {"qwen3-moe decode, gate/up, model rank 1 of 2": (1, 2)}


def gmm_draw(i):
    """Case i's experts E, group sizes (E,) and rows M (rows past
    sum(sizes) are the tail)."""
    label, E, k, M = GMM_CASES[i][:4]
    sizes = gmm_group_sizes(E, k, M, seed=500 + i)
    if label in GMM_RANKS:
        rank, ranks = GMM_RANKS[label]
        E //= ranks
        sizes = sizes[rank * E:(rank + 1) * E]
    return E, sizes, M


def ptxas_summary(report, match):
    """(entry function, registers, spill stores, spill loads) of each
    kernel in an nvcc -Xptxas -v report whose name contains ``match``."""
    out, fn = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn and match in fn:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and match in fn:
            out.append((fn, int(m.group(1)), *spills))
            fn = None
    return out


def gmm_group_sizes(E, k, M, seed):
    """Rows per expert of a skewed top-k routing draw of M / k tokens:
    each token takes k distinct experts, sampled without replacement
    (Gumbel top-k) from softmax(bias), bias ~ N(0, GMM_SKEW^2); the
    ``GMM_PADDED[M]`` padding tokens among them all take the first
    token's experts."""
    rng = np.random.default_rng(seed)
    bias = rng.standard_normal(E) * GMM_SKEW
    scores = bias + rng.gumbel(size=(M // k, E))
    top = np.argsort(-scores, axis=1)[:, :k]
    top[M // k - GMM_PADDED.get(M, 0):] = top[0]
    return np.bincount(top.reshape(-1), minlength=E)


def _gmm_library(op, a):
    """One ``torch._grouped_mm`` call for the same function (bf16 only; a
    yardstick, never called by the port): (fn, None), or (None, why)."""
    import torch
    if a["x"].dtype != torch.bfloat16 or not hasattr(torch, "_grouped_mm"):
        return None, "bf16 only"
    x, w, dy, ends = a["x"], a["w"], a["dy"], a["ends"]
    fn = {"fwd": lambda: torch._grouped_mm(x, w, offs=ends),
          "dx": lambda: torch._grouped_mm(dy, w.transpose(1, 2), offs=ends),
          "wgrad": lambda: torch._grouped_mm(x.t(), dy, offs=ends)}[op]
    try:
        fn()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 -- record why, time nothing
        return None, f"{type(e).__name__}: {str(e)[:200]}"
    return fn, None


def _gmm_group_share(out, ref, bounds, wgrad, atol, rtol):
    """The largest max |out - ref| / (atol + rtol max |ref|) over the
    groups, each on its own scale: the forward's groups with rows (their
    rows of the output), every expert's dw for the weight gradient (an
    empty group's must be zeros: its limit is atol).  At most 1: within
    TOL."""
    import torch
    if wgrad:
        diff = (out.float() - ref.float()).abs().amax(dim=(1, 2))
        top = ref.float().abs().amax(dim=(1, 2))
    else:
        starts = [int(b) for b, c in zip(bounds[:-1], bounds[1:]) if c > b]
        if not starts:
            return 0.0
        used = int(bounds[-1])
        d = (out[:used].float() - ref[:used].float()).abs().amax(dim=1)
        r = ref[:used].float().abs().amax(dim=1)
        d, r = d.cpu().numpy(), r.cpu().numpy()
        diff = torch.from_numpy(np.maximum.reduceat(d, starts))
        top = torch.from_numpy(np.maximum.reduceat(r, starts))
    return float((diff / (atol + rtol * top)).max())


def phase_grouped_mm():
    """grouped_mm (forward, the input gradient's transposed product) and
    grouped_mm_wgrad against their plain versions on the card.  Group
    sizes come from a skewed routing draw: empty groups, groups past a
    128-row tile (qwen3-moe's prefill, the padded bucket), one model
    rank's share with rows past ``ends[-1]``, weight-gradient groups over
    one 32-row stage whose size is not a multiple of 8.  The check is on
    each group's own scale, as a product's rounding is: for every group
    with rows (the forward: its rows of the output) and every expert (the
    weight gradient: its dw), max |kernel - plain| <= atol + rtol max
    |plain| over that group (TOL), so a fault the size of a small group's
    values fails however large another group's are; a second call must
    give the same bits.
    Times: kernel (L2 cold and warm), plain version, one
    ``torch._grouped_mm`` call (bf16; the library time) and a loop of
    per-expert ``torch.matmul`` calls over host-known segments (logged),
    the kernel / library ratio and the share of the bound.  Rows past
    ``ends[-1]`` must come back exactly zero.  The bound counts the bytes
    of the experts that have rows, each once, and 2 K N flops a row.
    Logs the grouped kernels' registers and spills (ptxas).  Returns the
    bf16 main-path record."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_mm as GM
    for fn, regs, st, ld in ptxas_summary(build.build_all()["grouped_mm"],
                                          "grouped_mm"):
        log(f"[kernels] ptxas {fn}: {regs} registers, spill stores {st} "
            f"bytes, spill loads {ld} bytes")
    main, ok = {}, True
    empty_seen = long_seen = odd_seen = tail_seen = False
    for i, (label, _, k, M, K, N, op, is_main) in enumerate(GMM_CASES):
        E, sizes, M = gmm_draw(i)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        segs = [(e, int(bounds[e]), int(bounds[e + 1])) for e in range(E)
                if sizes[e]]
        empty_seen |= bool((sizes == 0).any())
        long_seen |= bool(sizes.max() > GM.FWD_ROWS)
        tail_seen |= op != "wgrad" and int(bounds[-1]) < M
        odd_seen |= op == "wgrad" and bool(
            ((sizes > GM.WG_ROWS) & (sizes % 8 != 0)).any())
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(600 + i)
            a = dict(ends=torch.tensor(bounds[1:], dtype=torch.int32,
                                       device="cuda"))
            a["x"] = torch.randn(M, K, generator=g, device="cuda",
                                 dtype=dtype)
            a["w"] = torch.randn(E, K, N, generator=g, device="cuda",
                                 dtype=dtype).mul_(K ** -0.5)
            a["dy"] = torch.randn(M, N, generator=g, device="cuda",
                                  dtype=dtype)
            x, w, dy, ends = a["x"], a["w"], a["dy"], a["ends"]
            if op == "fwd":       # reads x and the used experts, writes y
                kern = lambda: GM.grouped_mm(x, w, ends)
                plain = lambda: GM.grouped_mm_ref(x, w, ends)
                loop = lambda: [torch.matmul(x[s:t], w[e])
                                for e, s, t in segs]
            elif op == "dx":      # reads dy and the used experts, writes dx
                kern = lambda: torch.ops.repro_torch.grouped_mm(dy, w, ends,
                                                                True)
                plain = lambda: GM.grouped_mm_ref(dy, w, ends, trans_w=True)
                loop = lambda: [torch.matmul(dy[s:t], w[e].t())
                                for e, s, t in segs]
            else:                 # reads x and dy, writes all of dw
                kern = lambda: GM.grouped_mm_wgrad(x, dy, ends)
                plain = lambda: GM.grouped_mm_wgrad_ref(x, dy, ends)
                loop = lambda: [torch.matmul(x[s:t].t(), dy[s:t])
                                for e, s, t in segs]
            out = kern()
            again = kern()
            ref = plain()
            torch.cuda.synchronize()
            atol, rtol = TOL[str(dtype)]
            err = float((out.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            group_share = _gmm_group_share(out, ref, bounds, op == "wgrad",
                                           atol, rtol)
            rows = int(bounds[-1])
            good = (group_share <= 1.0 and torch.equal(again, out)
                    and bool(torch.isfinite(out.float()).all())
                    and (op == "wgrad" or bool((out[rows:] == 0).all())))
            esz = x.element_size()
            used_w = len(segs) * K * N
            nbytes = esz * (x.numel() + dy.numel()
                            + (E * K * N if op == "wgrad" else used_w))
            nbytes += E * 4
            flops = 2 * rows * K * N
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / PEAK_FLOPS[str(dtype)] * 1e3
            lib, why = _gmm_library(op, a)
            if op == "wgrad" and dtype == torch.bfloat16:
                # the card's practical write rate: a fill of dw's bytes
                fill = torch.empty_like(ref)
                log(f"[kernels] {label}: a fill of dw's "
                    f"{fill.numel() * esz} bytes takes "
                    f"{_time_ms(fill.zero_)} ms")
                del fill
            ms = _time_ms(kern)
            lib_ms = _time_ms(lib) if lib is not None else None
            bound = max(t_bytes, t_flops)
            rec = dict(
                name="grouped_mm_wgrad" if op == "wgrad" else "grouped_mm",
                case=label, op=op, dtype=str(dtype), shape=[E, k, M, K, N],
                groups_with_rows=len(segs), largest_group=int(sizes.max()),
                tail_rows=M - rows, ok=good, max_abs_err=err,
                ref_max_abs=scale, worst_group_err_over_limit=group_share,
                ms=ms,
                ms_l2_warm=_time_ms(kern, cold=False),
                plain_ms=_time_ms(plain, iters=5),
                expert_loop_ms=_time_ms(loop, iters=5),
                library_ms=lib_ms, library_note=why,
                vs_library=ms / lib_ms if lib_ms else None,
                bound_share=bound / ms, bytes=nbytes, flops=flops,
                bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_flops else "operations")
            log("[kernels] " + json.dumps(rec))
            ok = ok and good
            if is_main and dtype == torch.bfloat16:
                main["grouped_mm"] = rec
            del a, x, w, dy, ends, out, again, ref, kern, plain, loop, lib
            torch.cuda.empty_cache()
    log(f"[kernels] grouped_mm draws: an empty group {empty_seen}, a group "
        f"past {GM.FWD_ROWS} rows {long_seen}, rows past ends[-1] "
        f"{tail_seen}, a weight-gradient group over {GM.WG_ROWS} rows and "
        f"not a multiple of 8 {odd_seen}")
    if not (ok and empty_seen and long_seen and tail_seen and odd_seen):
        raise RuntimeError("grouped_mm disagrees with its plain version (or "
                           "the draws missed an empty, a long, an odd group "
                           "or tail rows)")
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
    trace small); returns (wall s, summed kernel time s, every kernel
    [(name, s, calls)] by time), or None when the profiler reports no
    device time.  The profiler slows the host, so the share is a lower
    bound."""
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
    return wall, sum(r[1] for r in rows), rows


def profile_host_ops(fn):
    """Run ``fn`` under torch.profiler (host activity only); returns (the
    number of operator calls, nested calls included; the number of
    kernel launches; the top six events [(name, self CPU s, calls)]).
    The profiler slows each call, so the times are an upper bound; the
    counts are exact."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    rows = [(ev.key, ev.self_cpu_time_total / 1e6, ev.count)
            for ev in prof.key_averages()]
    rows.sort(key=lambda r: -r[1])
    n_ops = sum(c for k, _, c in rows if k.startswith("aten::"))
    n_launches = sum(c for k, _, c in rows if k == "cudaLaunchKernel")
    return n_ops, n_launches, rows[:6]


def outputs_sha(outputs) -> str:
    return hashlib.sha256(json.dumps(
        [[int(t) for t in o] for o in outputs]).encode()).hexdigest()[:16]


def phase_full_width(state):
    """Dense-cache main path at full width.  Leaves the bf16 weights, the
    prompts and their outputs in ``state`` for phase 5."""
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
    missing = [k for k in DENSE_PATH if synera_launches[k] == 0]
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
        for name, sec, calls in top[:8]:
            log(f"[full]   {sec:8.4f} s {calls:7d} calls  {name[:90]}")
        # the port's attention kernels in the window, wherever they rank
        for name, sec, calls in top:
            if any(k in name for k in PORT_KERNEL_SYMBOLS):
                log(f"[full]   port kernel: {sec:8.4f} s {calls:7d} calls  "
                    f"{name[:90]}")

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
    state.update(slm_cfg=slm_cfg, llm_cfg=llm_cfg, slm_p=slm_p, llm_p=llm_p,
                 prompts=prompts[:4], outputs=res.outputs[:4],
                 device="cuda")
    del eng, dev                    # frees the dense cache
    torch.cuda.empty_cache()
    return synera_launches


# ---------------------------------------------------------------------------
# Phase 4: tiny pair, kernels vs plain paths, token identity
# ---------------------------------------------------------------------------

def phase_tiny_identity(device="cuda"):
    from repro_torch.configs.synera_pair import tiny_pair
    from repro_torch.core.offload import OffloadPolicy
    from repro_torch.models import model as M
    from repro_torch.serving import synergy as SY
    from repro_torch.serving.device import DeviceRuntime
    from repro_torch.serving.engine import CloudEngine

    slm_cfg, llm_cfg = tiny_pair(vocab=64)
    slm_p = M.init_params(slm_cfg, seed=0, device=device)
    llm_p = M.init_params(llm_cfg, seed=1, device=device)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1], [5, 9]]
    shas = {}
    for impl in ("pallas", "plain"):
        sc = slm_cfg.replace(attn_impl="pallas" if impl == "pallas"
                             else "naive")
        lc = llm_cfg.replace(attn_impl="pallas" if impl == "pallas"
                             else "blocked")
        dev = DeviceRuntime(sc, slm_p, gamma=4, s_max=256, device=device,
                            policy=OffloadPolicy(c_th=0.8, i_th=0.04,
                                                 mode="both"))
        eng = CloudEngine(lc, llm_p, max_slots=4, s_max=256, device=device)
        r1 = SY.run_synera(dev, eng, prompts, 24, concurrency=2)
        r2 = SY.run_cloud_centric(eng, prompts[:1], 12)
        shas[impl] = (outputs_sha(r1.outputs), outputs_sha(r2.outputs))
        log(f"[tiny] {impl}: run_synera sha {shas[impl][0]}, "
            f"run_cloud_centric sha {shas[impl][1]}, offloaded "
            f"{sum(m.n_offloaded for m in r1.metrics)} chunks")
    if shas["pallas"] != shas["plain"]:
        raise RuntimeError(f"token streams differ: {shas}")

    # a paged engine that shares, retains and swaps on a pool too small
    # for its streams, through the kernels, against the dense engine on
    # the plain paths; the last prompt shares the first one's prefix
    prompts = prompts + [prompts[0] + [10, 11, 12]]
    runs = {}
    for impl, kw in (("plain dense", {}),
                     ("pallas paged", dict(
                         cache_impl="paged", block_size=4, pool_blocks=8,
                         share_prefix=True, retain_prefix=True, swap=True))):
        pallas = impl.startswith("pallas")
        sc = slm_cfg.replace(attn_impl="pallas" if pallas else "naive")
        lc = llm_cfg.replace(attn_impl="pallas" if pallas else "blocked")
        dev = DeviceRuntime(sc, slm_p, gamma=4, s_max=256, device=device,
                            policy=OffloadPolicy(c_th=0.8, i_th=0.04,
                                                 mode="both"))
        eng = CloudEngine(lc, llm_p, max_slots=4, s_max=256, device=device,
                          **kw)
        r1 = SY.run_synera(dev, eng, prompts, 24, concurrency=4)
        r2 = SY.run_cloud_centric(eng, prompts[:1], 12)
        runs[impl] = (outputs_sha(r1.outputs), outputs_sha(r2.outputs))
        st = r1.extras["scheduler"]
        log(f"[tiny] {impl}: run_synera sha {runs[impl][0]}, "
            f"run_cloud_centric sha {runs[impl][1]}; " + json.dumps(
                {k: st[k] for k in ("preemptions", "swap_evictions",
                                    "dedupe_hit_blocks", "cow_copies",
                                    "swap_out_bytes", "swap_in_bytes")}))
        if pallas:
            pool = eng.pool_stats
            if pool["free_blocks"] + pool["cached_free_blocks"] != \
                    pool["n_blocks"]:
                raise RuntimeError(f"tiny paged engine leaked blocks: {pool}")
    if runs["pallas paged"] != runs["plain dense"]:
        raise RuntimeError(f"paged token streams differ: {runs}")

    # the tiny pair with its LLM made MoE (tests/test_torch_moe.py's two
    # variants), each engine layout through the kernels and the plain paths
    prompts = tiny_moe_prompts()
    for label, (fields, kw) in TINY_MOE.items():
        moe_cfg = llm_cfg.replace(**fields)
        moe_p = M.init_params(moe_cfg, seed=1, device=device)
        shas = {}
        for impl in ("pallas", "plain"):
            pallas = impl == "pallas"
            sc = slm_cfg.replace(attn_impl="pallas" if pallas else "naive")
            lc = moe_cfg.replace(attn_impl="pallas" if pallas else "blocked")
            dev = DeviceRuntime(sc, slm_p, gamma=4, s_max=256, device=device,
                                policy=OffloadPolicy(mode="all"))
            eng = CloudEngine(lc, moe_p, max_slots=4, s_max=256,
                              device=device, **kw)
            r1 = SY.run_synera(dev, eng, prompts, 16, concurrency=2)
            r2 = SY.run_cloud_centric(eng, prompts[:2], 16)
            shas[impl] = (outputs_sha(r1.outputs), outputs_sha(r2.outputs))
            log(f"[tiny] moe {label} {impl}: run_synera sha {shas[impl][0]}, "
                f"run_cloud_centric sha {shas[impl][1]}, offloaded "
                f"{sum(m.n_offloaded for m in r1.metrics)} chunks")
        if shas["pallas"] != shas["plain"]:
            raise RuntimeError(f"moe {label} token streams differ: {shas}")


# tests/test_torch_moe.py's tiny MoE LLMs: (fields of the tiny LLM, engine
# keyword arguments)
TINY_MOE = {
    "dense": (dict(family="moe", n_layers=2, n_experts=4, top_k=2), {}),
    "paged": (dict(family="moe", n_layers=4, moe_every=2, n_experts=4,
                   top_k=1, n_shared_experts=1),
              dict(cache_impl="paged", block_size=16, share_prefix=True)),
}


def tiny_moe_prompts(seed=7):
    """Three prompts behind one 32-token common prefix and one of its own
    (tests/test_torch_moe.py's)."""
    rng = np.random.default_rng(seed)
    common = [int(t) for t in rng.integers(1, 60, size=32)]
    shared = [common + [int(t) for t in rng.integers(1, 60, size=n)]
              for n in (3, 9, 14)]
    return shared + [[int(t) for t in rng.integers(1, 60, size=20)]]


# ---------------------------------------------------------------------------
# Phase 5: the paged cloud path at full width
# ---------------------------------------------------------------------------

SYSTEM_TOKENS = 64               # shared system prompt: 4 full 16-token blocks
PAGED_POOL_BLOCKS = 46           # wave 1 needs 44 at admission, 56 at the end


def host_link_gbps(nbytes: int = 256 << 20, reps: int = 5) -> float:
    """Measured device-to-host copy rate into pinned memory (GB/s): the
    link the host swap tier moves blocks over."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst.copy_(src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dst.copy_(src)
    torch.cuda.synchronize()
    return reps * nbytes / (time.perf_counter() - t0) / 1e9


def phase_paged_full_width(state):
    """``run_synera`` and ``run_cloud_centric`` on a paged engine with
    prefix sharing, retention and host swap, reusing phase 3's weights.
    Wave 1: phase 3's four prompts behind one shared system prompt; wave
    2: two new prompts behind the same system prompt; then one
    cloud-centric stream.  Returns the launches of the path."""
    import torch
    from repro_torch.core.offload import OffloadPolicy
    from repro_torch.serving import device as device_mod
    from repro_torch.serving import synergy as SY
    from repro_torch.serving.device import DeviceRuntime
    from repro_torch.serving.engine import CloudEngine
    from repro_torch.serving.link import CloudLatencyModel

    dev_type = state["device"]
    slm_cfg, llm_cfg = state["slm_cfg"], state["llm_cfg"]
    rng = np.random.default_rng(5)
    system = rng.integers(1, slm_cfg.vocab, SYSTEM_TOKENS).tolist()
    wave1 = [system + p for p in state["prompts"]]
    wave2 = [system + rng.integers(1, slm_cfg.vocab, n).tolist()
             for n in (96, 160)]
    max_new = 32
    bs, max_slots, s_max = 16, 8, 2048
    # final length of a wave-1 stream: prompt + max_new + one verify
    # chunk of gamma + 1 rows; the shared system blocks count once
    final = [-(-(len(p) + max_new + 5) // bs) for p in wave1]
    shared = SYSTEM_TOKENS // bs
    distinct = sum(final) - shared * (len(wave1) - 1)
    P = PAGED_POOL_BLOCKS
    if P >= distinct:
        raise RuntimeError(f"pool of {P} blocks holds all of wave 1's "
                           f"{distinct} final blocks: nothing to preempt")
    t0 = time.perf_counter()
    dev = DeviceRuntime(slm_cfg, state["slm_p"], s_max=512, gamma=4,
                        policy=OffloadPolicy(mode="all"), device=dev_type)
    eng = CloudEngine(llm_cfg, state["llm_p"], max_slots=max_slots,
                      s_max=s_max, cache_impl="paged", block_size=bs,
                      paged_block_kv=128, kv_splits=1, share_prefix=True,
                      retain_prefix=True, swap=True, pool_blocks=P,
                      device=dev_type)
    _sync(dev_type)
    log(f"[paged] init {time.perf_counter() - t0:.3f} s; pool {P} blocks "
        f"of {bs} tokens ({P * eng.block_bytes() / 2**30:.2f} GiB; wave 1 "
        f"ends on {distinct} distinct blocks)")
    # The scheduler chooses swap or recompute eviction on its modeled
    # clock.  At the default 6 GB/s host link a full-width victim's swap
    # round trip costs more than refeeding one chunk, so every eviction
    # would recompute; under retain_prefix a recompute-evicted stream
    # re-adopts its own retained blocks, frees nothing, and the
    # scheduler (the reference's, carried over whole) livelocks (ROADMAP
    # queue 3, R3).  The clock models this host's measured link instead.
    link = host_link_gbps()
    latency = CloudLatencyModel(host_link_gbps=link)
    log(f"[paged] modeled host link: {link:.2f} GB/s (pinned D2H, "
        f"measured)")

    timer = HostTimer()
    timer.wrap(dev, "_one_token", "device SLM token step")
    timer.wrap(dev, "_prefill", "device prompt feed")
    timer.wrap(device_mod.EE, "pick_exit_layer", "early-exit pick (host)")
    for name in ("feed", "prefill"):
        timer.wrap(eng, name, f"cloud engine.{name}")
    timer.wrap(eng.swap_manager, "swap_out", "host swap out")
    timer.wrap(eng.swap_manager, "swap_in", "host swap in")
    # the device feeds a prompt at a modeled cost per token before it
    # reaches the cloud, so a shorter prompt starts that much later: all
    # four streams are admitted together and grow together, and the pool
    # must preempt (through swap: the round trip is modeled far cheaper
    # than a refeed) before they reach their final lengths
    longest = max(len(p) for p in wave1)
    arrivals = [(longest - len(p)) * dev.latency.ms_per_token for p in wave1]
    reset_launches()
    _sync(dev_type)
    t0 = time.perf_counter()
    r1 = SY.run_synera(dev, eng, wave1, max_new, concurrency=4,
                       arrivals=arrivals, latency=latency)
    _sync(dev_type)
    wall1 = time.perf_counter() - t0
    st1 = dict(r1.extras["scheduler"])
    t0 = time.perf_counter()
    r2 = SY.run_synera(dev, eng, wave2, max_new, concurrency=2,
                       latency=latency)
    _sync(dev_type)
    wall2 = time.perf_counter() - t0
    timer.restore()
    st2 = dict(r2.extras["scheduler"])
    t0 = time.perf_counter()
    rc = SY.run_cloud_centric(eng, wave1[:1], 8)
    _sync(dev_type)
    wall_c = time.perf_counter() - t0
    launches = read_launches()

    n1 = sum(len(o) for o in r1.outputs)
    n2 = sum(len(o) for o in r2.outputs)
    log("[paged] host time by part, both waves (s): " + json.dumps(
        {k: round(v, 3) for k, v in timer.seconds.items()}))
    log(f"[paged] wave 1: {len(wave1)} prompts, {n1} tokens in {wall1:.2f} s "
        f"wall ({n1 / wall1:.1f} tokens/s); sha {outputs_sha(r1.outputs)}")
    log(f"[paged] wave 2: {len(wave2)} prompts, {n2} tokens in {wall2:.2f} s "
        f"wall ({n2 / wall2:.1f} tokens/s); sha {outputs_sha(r2.outputs)}")
    log(f"[paged] run_cloud_centric: 8 tokens in {wall_c:.2f} s wall")
    keys = ("iterations", "prefill_iterations", "verify_iterations",
            "mean_verify_occupancy", "preemptions", "swap_evictions",
            "recompute_evictions", "admission_swaps", "prefill_fed_tokens",
            "dedupe_hit_blocks", "revived_blocks", "reclaimed_blocks",
            "swap_out_bytes", "swap_in_bytes", "peak_used_blocks")
    log("[paged] wave 1 scheduler: " + json.dumps({k: st1[k] for k in keys}))
    log("[paged] wave 2 scheduler: " + json.dumps({k: st2[k] for k in keys}))
    agree = sum(int(a == b) for o, d in zip(r1.outputs, state["outputs"])
                for a, b in zip(o, d))
    log(f"[paged] wave-1 tokens equal to phase 3's dense run of the same "
        f"prompts without the system prompt: {agree} of {n1}")
    log(f"[paged] launches {json.dumps(launches)}")

    pool = eng.pool_stats
    log("[paged] pool at the end: " + json.dumps(
        {k: pool[k] for k in ("n_blocks", "free_blocks", "cached_free_blocks",
                              "used_blocks", "swapped_blocks",
                              "dedupe_hit_blocks", "revived_blocks",
                              "swap_out_bytes", "swap_in_bytes")}))
    for outs, n in ((r1.outputs, max_new), (r2.outputs, max_new),
                    (rc.outputs, 8)):
        for o in outs:
            if len(o) != n or not all(0 <= t < llm_cfg.vocab for t in o):
                raise RuntimeError(f"bad paged output {o}")
    checks = {
        "paged decode kernel launched":
            launches["decode_attention_paged"] > 0,
        "paged partial-prefill kernel launched":
            launches["partial_prefill_attention_paged"] > 0,
        "prefix dedupe hits": st1["dedupe_hit_blocks"] > 0,
        "wave 2 revived retained blocks":
            st2["revived_blocks"] > st1["revived_blocks"],
        "a preemption went through swap": st1["swap_evictions"] > 0,
        "swap-out bytes": pool["swap_out_bytes"] > 0,
        "swap-in bytes": pool["swap_in_bytes"] > 0,
        "no leaked blocks": (pool["free_blocks"] + pool["cached_free_blocks"]
                             == pool["n_blocks"]),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"paged full-width run failed: {failed}")
    del eng, dev
    if dev_type == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the fleet router and the serve launcher (runs after phase 5)
# ---------------------------------------------------------------------------

FLEET_SYSTEM_TOKENS = 128        # the shared system prompt: 8 full blocks
FLEET_MAX_NEW = 16


def fleet_prompts(vocab: int) -> list[list[int]]:
    """Six prompts: three behind one 128-token system prompt (suffixes of
    64, 128 and 192 tokens), three without (64, 128, 256).  At
    concurrency 4 the first shared prompt opens with the three plain
    ones; the device feeds a prompt at a modeled 30 ms a token before
    the cloud sees it, so the shortest plain stream ends after the
    shared one's prefill and before that stream ends: the two shared
    prompts opened next find its blocks live (prefix-affinity)."""
    rng = np.random.default_rng(0)
    system = rng.integers(1, vocab, FLEET_SYSTEM_TOKENS).tolist()
    shared = {n: system + rng.integers(1, vocab, n).tolist()
              for n in (64, 128, 192)}
    plain = {n: rng.integers(1, vocab, n).tolist() for n in (64, 128, 256)}
    return [shared[64], plain[64], plain[128], plain[256], shared[128],
            shared[192]]


class ReplicaLaunches:
    """Paged partial-prefill launches made inside each replica engine's
    ``feed`` / ``prefill`` (the counter is global; serving is one
    thread, so the difference across a call is that replica's)."""

    def __init__(self, engines):
        from repro_torch.kernels import partial_prefill
        self.mod = partial_prefill
        self.counts = [0] * len(engines)
        self._undo = []
        for i, eng in enumerate(engines):
            for name in ("feed", "prefill"):
                self._wrap(eng, name, i)

    def _wrap(self, eng, name, i):
        fn = getattr(eng, name)

        def counted(*a, **k):
            before = self.mod.paged_launches
            try:
                return fn(*a, **k)
            finally:
                self.counts[i] += self.mod.paged_launches - before

        setattr(eng, name, counted)
        self._undo.append((eng, name))

    def restore(self):
        for eng, name in self._undo:
            delattr(eng, name)          # the class's method again
        self._undo.clear()


def _fleet_engine(state, **kw):
    from repro_torch.serving.engine import CloudEngine
    return CloudEngine(state["llm_cfg"], state["llm_p"], max_slots=4,
                       s_max=512, cache_impl="paged", block_size=16,
                       share_prefix=True, device=state["device"], **kw)


def _tokens_per_s(outputs, wall):
    n = sum(len(o) for o in outputs)
    return n, n / wall


def fleet_gateway_check(device, prompt, max_new):
    """One streamed chat completion over a socket, through a ``Gateway``
    over a two-replica router of the tiny pair; returns its tokens and
    the batch run's (``run_synera``) for the same prompt."""
    import socket
    from repro_torch.configs.synera_pair import tiny_pair
    from repro_torch.core.offload import OffloadPolicy
    from repro_torch.models import model as M
    from repro_torch.serving.device import DeviceRuntime
    from repro_torch.serving.engine import CloudEngine
    from repro_torch.serving.gateway import Gateway, GatewayConfig
    from repro_torch.serving.gateway import protocol as P
    from repro_torch.serving.link import RealClock
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.serving.server import build_fleet
    from repro_torch.serving import synergy as SY

    slm_cfg, llm_cfg = (c.replace(attn_impl="pallas")
                        for c in tiny_pair(vocab=64))
    slm_p = M.init_params(slm_cfg, seed=0, device=device)
    llm_p = M.init_params(llm_cfg, seed=1, device=device)

    def engines(n):
        return [CloudEngine(llm_cfg, llm_p, max_slots=2, s_max=256,
                            cache_impl="paged", block_size=16,
                            share_prefix=True, device=device)
                for _ in range(n)]

    dev = DeviceRuntime(slm_cfg, slm_p, s_max=256, gamma=4,
                        policy=OffloadPolicy(mode="all"), device=device)
    batch = [int(t) for t in SY.run_synera(dev, engines(1)[0], [prompt],
                                           max_new).outputs[0]]
    router = ReplicaRouter(build_fleet(dev, engines(2), clock=RealClock(),
                                       clamp_arrivals=True),
                           policy="prefix-affinity")
    gw = Gateway(router, GatewayConfig(port=0, max_active=2,
                                       queue_cap=2)).start()
    body = json.dumps({"model": "synera-tiny", "stream": True,
                       "max_tokens": max_new,
                       "messages": [{"role": "user",
                                     "content": P.detok(prompt)}]}).encode()
    data = b""
    try:
        with socket.create_connection(("127.0.0.1", gw.port),
                                      timeout=60) as sock:
            sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\n"
                         b"Host: localhost\r\nConnection: close\r\n"
                         b"Content-Type: application/json\r\n"
                         + f"Content-Length: {len(body)}\r\n\r\n".encode()
                         + body)
            while chunk := sock.recv(65536):
                data += chunk
    finally:
        gw.close()
    if any(t.is_alive() for t in gw._threads):
        raise RuntimeError("gateway threads outlived close()")
    head, _, sse = data.partition(b"\r\n\r\n")
    frames = [f[len(b"data: "):] for f in sse.split(b"\n\n")
              if f.startswith(b"data: ")]
    if not head.startswith(b"HTTP/1.1 200") or frames[-1:] != [b"[DONE]"]:
        raise RuntimeError(f"gateway answered {head[:40]!r}, "
                           f"{len(frames)} frames")
    text = "".join(json.loads(f)["choices"][0]["delta"].get("content", "")
                   for f in frames[:-1])
    return P.parse_tokens(text), batch


def phase_fleet(state):
    """The fleet at full width (phase 3's bf16 160M/7B pair, paged
    replicas that share prefixes without retention, pools that never
    preempt): a one-engine oracle, two replicas under prefix-affinity and
    round-robin, a replica killed mid-verify, a saturated replica that
    degrades to the device; then the serve launcher and the HTTP gateway
    on the tiny pair."""
    import torch
    from repro_torch.core.offload import OffloadPolicy
    from repro_torch.launch import serve
    from repro_torch.serving import synergy as SY
    from repro_torch.serving.device import DeviceRuntime
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.serving.server import WAIT_CLOUD, build_fleet

    dev_type = state["device"]
    gc.collect()                    # phases 3 and 5 left no engine behind
    if dev_type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"[fleet] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated before the replicas (the pair's weights)")
    prompts = fleet_prompts(state["slm_cfg"].vocab)
    max_new = FLEET_MAX_NEW
    dev = DeviceRuntime(state["slm_cfg"], state["slm_p"], s_max=512,
                        gamma=4, policy=OffloadPolicy(mode="all"),
                        device=dev_type)
    checks = {}

    def timed(fn):
        _sync(dev_type)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev_type)
        return out, time.perf_counter() - t0

    oracle, wall = timed(lambda: SY.run_synera(
        dev, _fleet_engine(state), prompts, max_new, concurrency=4))
    want = outputs_sha(oracle.outputs)
    n, tps = _tokens_per_s(oracle.outputs, wall)
    log(f"[fleet] oracle (one replica): {n} tokens in {wall:.2f} s wall "
        f"({tps:.1f} tokens/s); sha {want}")
    for o in oracle.outputs:
        if len(o) != max_new or not all(0 <= t < state["llm_cfg"].vocab
                                        for t in o):
            raise RuntimeError(f"bad fleet oracle output {o}")

    engines = [_fleet_engine(state), _fleet_engine(state)]
    for policy in ("prefix-affinity", "round-robin"):
        per_replica = ReplicaLaunches(engines)
        res, wall = timed(lambda: SY.run_synera_fleet(
            dev, engines, prompts, max_new, policy=policy, concurrency=4))
        per_replica.restore()
        st, reps = res.extras["scheduler"], res.extras["replicas"]
        n, tps = _tokens_per_s(res.outputs, wall)
        log(f"[fleet] {policy}, 2 replicas: {n} tokens in {wall:.2f} s wall "
            f"({tps:.1f} tokens/s); sha {outputs_sha(res.outputs)}; "
            f"affinity_hits {st['affinity_hits']}; per replica: " +
            json.dumps([{k: r[k] for k in ("completed_streams", "iterations",
                                           "peak_used_blocks", "n_blocks",
                                           "dedupe_hit_blocks")}
                        for r in reps]) +
            f"; paged prefill launches per replica {per_replica.counts}")
        checks[f"{policy}: streams equal the oracle"] = \
            outputs_sha(res.outputs) == want
        checks[f"{policy}: both replicas served sessions"] = all(
            r["completed_streams"] > 0 for r in reps)
        checks[f"{policy}: paged prefill kernel on both replicas"] = all(
            c > 0 for c in per_replica.counts)
        if policy == "prefix-affinity":
            checks["affinity_hits >= 1"] = st["affinity_hits"] >= 1
    del engines

    router = ReplicaRouter(build_fleet(dev, [_fleet_engine(state),
                                             _fleet_engine(state)]),
                           policy="round-robin")

    def kill_run():
        sess = [router.open_session(p, max_new) for p in prompts]
        for _ in range(2000):
            router.step()
            if any(s.state == WAIT_CLOUD
                   for s in router.replicas[1].sessions if not s.done):
                break
        else:
            raise RuntimeError("replica 1 never held a session in WAIT_CLOUD")
        moved = router.kill_replica(1)
        while router.step():
            pass
        return [s.metrics.tokens for s in sess], moved

    (outs, moved), wall = timed(kill_run)
    st = router.stats()
    n, tps = _tokens_per_s(outs, wall)
    log(f"[fleet] kill replica 1 mid-verify: {moved} sessions moved; {n} "
        f"tokens in {wall:.2f} s wall ({tps:.1f} tokens/s); sha "
        f"{outputs_sha(outs)}; rerouted_sessions {st['rerouted_sessions']}, "
        f"dead_replicas {st['dead_replicas']}")
    checks["kill: streams equal the oracle"] = outputs_sha(outs) == want
    checks["rerouted_sessions >= 1"] = st["rerouted_sessions"] >= 1
    checks["dead_replicas == 1"] = st["dead_replicas"] == 1
    del router

    router = ReplicaRouter(build_fleet(dev, [_fleet_engine(state)]),
                           policy="least-loaded", replica_queue_cap=1)
    metrics, wall = timed(lambda: router.serve(prompts[:3], max_new,
                                               concurrency=2))
    st = router.stats()
    degraded = [m for s, m in zip(router.sessions, metrics)
                if router.owner[id(s)] == -1]
    served = [(i, m) for i, (s, m) in enumerate(zip(router.sessions,
                                                    metrics))
              if router.owner[id(s)] == 0]
    n, tps = _tokens_per_s([m.tokens for m in metrics], wall)
    log(f"[fleet] saturation (queue cap 1, one replica): {n} tokens in "
        f"{wall:.2f} s wall ({tps:.1f} tokens/s); degraded_streams "
        f"{st['degraded_streams']}; degraded cloud tokens "
        f"{[m.n_cloud_tokens for m in degraded]}")
    checks["degraded_streams >= 1"] = st["degraded_streams"] >= 1
    checks["degraded streams: max_new tokens, no cloud tokens"] = all(
        len(m.tokens) == max_new and m.n_cloud_tokens == 0
        for m in degraded)
    checks["saturation: served streams equal the oracle"] = all(
        [int(t) for t in m.tokens] == [int(t) for t in oracle.outputs[i]]
        for i, m in served)
    del router, dev
    if dev_type == "cuda":
        log(f"[fleet] peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; {torch.cuda.memory_allocated() / 2**30:.2f} GiB now")

    # --budget 1.0: the random SLM's profiled thresholds offload nothing
    # at the default 0.2, and the launcher's fleet would not verify
    argv = [
        "--random-weights", "--budget", "1.0", "--attn-impl", "pallas",
        "--cache-impl", "paged", "--share-prefix",
        "--shared-prefix-tokens", "32", "--requests", "4",
        "--max-new", "16", "--json", "--device", dev_type]
    sums = {}
    for reps in (["--replicas", "1"],
                 ["--replicas", "2", "--route-policy", "prefix-affinity"]):
        t0 = time.perf_counter()
        sums[reps[1]] = serve.main(argv + reps)
        log(f"[fleet] launcher {' '.join(reps)}: "
            f"{time.perf_counter() - t0:.2f} s; sha "
            f"{sums[reps[1]]['outputs_sha']}, iterations "
            f"{sums[reps[1]]['iterations']}")
    checks["launcher: 1 and 2 replicas give one sha"] = \
        sums["1"]["outputs_sha"] == sums["2"]["outputs_sha"]
    checks["launcher: the cloud verified"] = all(
        s["iterations"] > 0 for s in sums.values())

    t0 = time.perf_counter()
    streamed, batch = fleet_gateway_check(dev_type, list(range(3, 19)), 12)
    log(f"[fleet] gateway: streamed {streamed} in "
        f"{time.perf_counter() - t0:.2f} s (batch run {batch})")
    checks["gateway: streamed tokens equal the batch run's"] = \
        streamed == batch and len(batch) == 12

    failed = [k for k, v in checks.items() if not v]
    log("[fleet] checks: " + json.dumps(checks))
    if failed:
        raise RuntimeError(f"fleet phase failed: {failed}")
    if dev_type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8: the reference's other dense configs at full width
# ---------------------------------------------------------------------------

# (config, layers kept or None for all): qwen1.5-110b is ~222 GB in bf16,
# so it keeps 8 of its 80 layers, every width as published
DENSE_CONFIGS = [("llama3.2-1b", None), ("qwen2-1.5b", None),
                 ("glm4-9b", None), ("qwen1.5-110b", 8)]
DENSE_SLOTS, DENSE_S_MAX, DENSE_MAX_NEW = 4, 512, 16
DENSE_COSINE_GATE = 0.999


def _weights_gib(params) -> float:
    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict)
                   else v.numel() * v.element_size() for v in tree.values())
    return nbytes(params) / 2**30


def dense_prompts(vocab: int) -> list[list[int]]:
    rng = np.random.default_rng(8)
    return [rng.integers(1, vocab, n).tolist() for n in (64, 128, 192, 256)]


def phase_dense_configs(configs=DENSE_CONFIGS, device="cuda"):
    """Each dense config of the reference at full width in bf16, random
    weights from a seed, on a dense ``CloudEngine`` through the kernels:
    ``run_cloud_centric`` on four prompts of 64-256 tokens, 16 new tokens
    each (the function serves its prompts one after another).  Checks
    that both dense attention kernels launched and that nothing else
    did, that the prefill logits of the prompts keep cosine >= 0.999
    against the plain (blocked) attention path, and that at 2 layers and
    full width in float32 the greedy streams through the kernels and the
    plain path are identical.  Frees each config before the next."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import splits as SP
    from repro_torch.models import model as M
    from repro_torch.serving import synergy as SY
    from repro_torch.serving.engine import CloudEngine

    checks = {}
    sms = SP.sm_count(torch.device(device)) if device == "cuda" else \
        SP.SM_COUNT
    for name, depth in configs:
        full = get_config(name)
        cfg = full.replace(attn_impl="pallas")
        if depth is not None:
            cfg = cfg.replace(n_layers=depth)
        g = cfg.n_heads // cfg.n_kv_heads
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed=0, device=device)
        eng = CloudEngine(cfg, params, max_slots=DENSE_SLOTS,
                          s_max=DENSE_S_MAX, device=device)
        _sync(device)
        cut = (f"{cfg.n_layers} of {full.n_layers} layers (cut: the whole "
               f"model does not fit one card), widths as published"
               if depth is not None else f"{cfg.n_layers} layers")
        log(f"[dense] {name}: {cut}; d_model {cfg.d_model}, {cfg.n_heads} "
            f"heads / {cfg.n_kv_heads} kv (g {g}) x {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}, qkv_bias {cfg.qkv_bias}, tied "
            f"{cfg.tie_embeddings}; {_weights_gib(params):.2f} GiB of bf16 "
            f"weights; init {time.perf_counter() - t0:.2f} s")
        prompts = dense_prompts(cfg.vocab)
        with torch.no_grad():       # warm-up: library handles, allocator
            SY.run_cloud_centric(eng, prompts[:1], 2)
        if device == "cuda":        # the serving peak, not init's f32 draws
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            res = SY.run_cloud_centric(eng, prompts, DENSE_MAX_NEW)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = read_launches()
        n_tok = sum(len(o) for o in res.outputs)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else float("nan"))
        grids = {f"prefill C={c}": SP.dense_grid(
            DENSE_SLOTS, cfg.n_kv_heads, g * c, DENSE_S_MAX, decode=False,
            sms=sms) for c in eng.compile_stats["buckets"]}
        grids["decode"] = SP.dense_grid(DENSE_SLOTS, cfg.n_kv_heads, g,
                                        DENSE_S_MAX, decode=True, sms=sms)
        log(f"[dense] {name}: run_cloud_centric, {len(prompts)} prompts, "
            f"{n_tok} tokens in {wall:.2f} s wall ({n_tok / wall:.1f} "
            f"tokens/s); sha {outputs_sha(res.outputs)}; peak "
            f"{peak:.2f} GiB allocated; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}; "
            f"splits / grid: " + json.dumps(grids))
        checks[f"{name}: outputs"] = all(
            len(o) == DENSE_MAX_NEW and all(0 <= t < cfg.vocab for t in o)
            for o in res.outputs)
        checks[f"{name}: both dense attention kernels, nothing else"] = (
            launches["partial_prefill_attention"] > 0
            and launches["decode_attention"] > 0
            and all(v == 0 for k, v in launches.items()
                    if k not in ("partial_prefill_attention",
                                 "decode_attention")))
        del eng

        # prefill logits of the same prompts: kernels vs plain attention,
        # and (logged: the floor under the gate) the plain path in a
        # second legitimate order, naive vs blocked attention
        cos, floor = [], []
        with torch.no_grad():
            for p in prompts:
                toks = torch.tensor([p], device=device)
                pos = M.default_positions(1, len(p), device=device)
                lk, lp, ln = (M.forward(cfg.replace(attn_impl=impl), params,
                                        toks, pos)[0]
                              for impl in ("pallas", "blocked", "naive"))
                cos.append(_cosine(lk, lp))
                floor.append(_cosine(ln, lp))
                del lk, lp, ln
        log(f"[dense] {name}: prefill logits, kernel vs plain cosine per "
            f"prompt {[round(c, 6) for c in cos]}; gate {DENSE_COSINE_GATE};"
            f" plain naive vs blocked {[round(c, 6) for c in floor]}")
        checks[f"{name}: prefill cosine >= {DENSE_COSINE_GATE}"] = \
            min(cos) >= DENSE_COSINE_GATE
        del params
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # 2 layers at full width in float32: kernel vs plain streams
        c32 = cfg.replace(n_layers=2, dtype="float32")
        p32 = M.init_params(c32, seed=1, device=device)
        shas = {}
        for impl in ("pallas", "blocked"):
            eng = CloudEngine(c32.replace(attn_impl=impl), p32,
                              max_slots=DENSE_SLOTS, s_max=DENSE_S_MAX,
                              device=device)
            with torch.no_grad():
                shas[impl] = outputs_sha(SY.run_cloud_centric(
                    eng, prompts, DENSE_MAX_NEW).outputs)
            del eng
        log(f"[dense] {name}: 2 layers f32, kernel stream sha "
            f"{shas['pallas']}, plain stream sha {shas['blocked']}")
        checks[f"{name}: f32 streams identical"] = \
            shas["pallas"] == shas["blocked"]
        del p32
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    failed = [k for k, v in checks.items() if not v]
    log("[dense] checks: " + json.dumps(checks))
    if failed:
        raise RuntimeError(f"dense-configs phase failed: {failed}")


# ---------------------------------------------------------------------------
# Phase 6: the Mamba2 (SSM) family at full width
# ---------------------------------------------------------------------------

def _cosine(a, b) -> float:
    import torch
    return float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))


def _greedy(cfg, params, prompts, n_new, device, *, aux_inputs=None,
            s_max=None):
    """Batched prefill of equal-length prompts (with the vlm's or the
    audio family's ``aux_inputs``), then ``n_new`` greedy decode steps,
    over a cache of ``s_max`` slots (default just enough).  Returns
    (prefill last logits, tokens (B, n_new + 1), prefill s, decode s)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    B, T = prompts.shape
    prefill, decode = S.make_prefill_step(cfg), S.make_decode_step(cfg)
    cache = M.init_cache(cfg, B, s_max or T + n_new, device=device)
    _sync(device)
    t0 = time.perf_counter()
    last, cache = prefill(params, cache, prompts, aux_inputs)
    _sync(device)
    t1 = time.perf_counter()
    toks = [last.argmax(-1)]
    for i in range(n_new):
        pos = torch.full((B, 1), T + i, dtype=torch.int32, device=device)
        logits, cache = decode(params, cache, toks[-1][:, None], pos)
        toks.append(logits.argmax(-1))
    _sync(device)
    t2 = time.perf_counter()
    return last, torch.stack(toks, 1), t1 - t0, t2 - t1


# Phase 9's kernel-vs-plain prefill cosine at full depth is logged, not
# gated.  On random weights through zamba2's 63 blocks the plain path
# against itself in a second legitimate order gives cosine 0.879857
# (naive vs blocked attention) and 0.899075 (SSD chunk 128 vs 256) on the
# H100 (PERF.md section 6), so no cosine gate on those logits can tell a
# kernel fault from rounding.  The gate sits at one round instead (6
# Mamba2 layers and one application of the shared block, full width,
# bf16), where the blocks amplify a rounding difference little: the plain
# path's floor there must clear the gate, and then the kernel path must.
HYBRID_PLAIN_GATE = None
HYBRID_ROUND_GATE = 0.999


def expected_launches(cfg, n_forwards, n_decode):
    """Exact kernel launches of ``n_forwards`` multi-token forwards and
    ``n_decode`` decode steps of an ssm or hybrid model on its kernel
    path: ``ssd_scan`` once per Mamba2 layer of a multi-token forward;
    the hybrid's shared attention block, once per round, launches
    ``partial_prefill_attention`` in a multi-token forward and
    ``decode_attention`` in a decode step; nothing else."""
    rounds = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else 0)
    want = {k: 0 for k in kernel_modules()}
    want.update(ssd_scan=n_forwards * cfg.n_layers,
                partial_prefill_attention=n_forwards * rounds,
                decode_attention=n_decode * rounds)
    return want


def ssm_inputs(cfg, batch, prompt_len, device):
    """Phases 6 and 9's weights (seed 0) and equal-length prompts."""
    import torch
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(6)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab, (batch, prompt_len))).to(device)
    return params, prompts


def _prefill_last(cfg, params, prompts):
    """Last-position logits of a batched prefill through ``cfg``'s path."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    with torch.no_grad():
        cache = M.init_cache(cfg, *prompts.shape, device=prompts.device)
        return S.make_prefill_step(cfg)(params, cache, prompts)[0]


def plain_floor(cfg, params, prompts):
    """The prefill's last-position logits on the plain path (blocked
    attention, ``ssd_chunked``) and, by label, the cosine of the same
    prefill in a second legitimate order: half the SSD chunk (the same
    exact algorithm, its f32 sums split otherwise) and, for the hybrid,
    naive (materialized) instead of blocked attention.  Those cosines are
    the floor under any kernel-vs-plain gate; each is logged."""
    plain_cfg = cfg.replace(attn_impl="blocked")
    plain = _prefill_last(plain_cfg, params, prompts)
    orders = {}
    if cfg.ssm_chunk % 2 == 0:
        orders[f"SSD chunk {cfg.ssm_chunk // 2} vs {cfg.ssm_chunk}"] = \
            plain_cfg.replace(ssm_chunk=cfg.ssm_chunk // 2)
    if cfg.family == "hybrid":
        orders["naive vs blocked attention"] = cfg.replace(attn_impl="naive")
    floors = {}
    for label, ocfg in orders.items():
        floors[label] = _cosine(_prefill_last(ocfg, params, prompts), plain)
        log(f"[{cfg.family}] {cfg.n_layers} layers: prefill, plain path, "
            f"{label} (another legitimate order): cosine "
            f"{floors[label]:.6f}")
    return plain, floors


def _blocked_bf16_p(q, k, v, q_pos, kv_pos, *, block_kv=1024, window=0,
                    causal=True):
    """The plain blocked attention with P rounded to bf16 before P.V, as
    ``partial_prefill``'s bf16 tensor-core path rounds it (m, l and the
    accumulator stay f32).  A witness for what that rounding alone does
    to the logits; never on a served path."""
    import math
    import torch
    from repro_torch.models import layers as L
    B, Tq, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    bk = min(block_kv, S)
    qf = q.float() * (1.0 / math.sqrt(hd))
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((B, nh, Tq), L.NEG_INF, **f32)
    l = torch.zeros((B, nh, Tq), **f32)
    acc = torch.zeros((B, nh, Tq, hd), **f32)
    for s0 in range(0, S, bk):
        kf = k[:, s0:s0 + bk].float().repeat_interleave(g, dim=2)
        vf = v[:, s0:s0 + bk].float().repeat_interleave(g, dim=2)
        s = torch.einsum("bthd,bshd->bhts", qf, kf)
        s = s + L._mask_bias(q_pos, kv_pos[:, s0:s0 + bk], window,
                             causal)[:, None]
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        p16 = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bhts,bshd->bhtd", p16, vf)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).permute(0, 2, 1, 3).reshape(B, Tq, nh, hd)
    return out.to(q.dtype)


def bf16_p_witness(cfg, params, prompts, plain):
    """Cosine of the plain path with P rounded to bf16 before P.V
    (``_blocked_bf16_p`` in place of the blocked attention) against the
    plain path's logits ``plain``: how far the kernel's one deliberate
    rounding carries through ``cfg``'s depth."""
    from unittest import mock
    from repro_torch.models import layers as L
    with mock.patch.object(L, "blocked_attention", _blocked_bf16_p):
        last = _prefill_last(cfg.replace(attn_impl="blocked"), params,
                             prompts)
    return _cosine(last, plain)


def phase_ssm(cfg=None, *, tiny=None, batch=4, prompt_len=512, n_new=32,
              plain_gate=0.999, device="cuda"):
    """An ssm or hybrid model at full width through the model-level
    serving steps (neither family can go through CloudEngine: bucket
    padding would enter the Mamba2 state, R6): ``mamba2-2.7b`` by default
    (phase 6), ``zamba2-2.7b`` in phase 9.  Main path, counted: a batched
    prefill, ``n_new`` greedy decode steps, and a chunked feed on a fresh
    cache (prefill the first half, then the second half through the
    verify step: the h0 and T > 1 conv_step path, and for the hybrid a
    chunk over a cached prefix); every kernel's launches must equal
    :func:`expected_launches`.  Then, uncounted: the same prefill on the
    plain path, the plain path in a second legitimate order (the floor
    of any kernel-vs-plain gate), a profiled window, and ``tiny`` (default
    the reduced config) in float32 through both paths, whose greedy
    streams must be identical.  ``plain_gate``: the least kernel-vs-plain
    cosine of the prefill logits, or None to log it only.  Returns the
    launches of the main path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import steps as S

    cfg = cfg or get_config("mamba2-2.7b").replace(attn_impl="pallas")
    tiny = tiny or get_config(cfg.name).reduced()
    tag = f"[{cfg.family}]"
    t0 = time.perf_counter()
    params, prompts = ssm_inputs(cfg, batch, prompt_len, device)
    _sync(device)
    def numel(tree):
        return sum(numel(v) if isinstance(v, dict) else v.numel()
                   for v in tree.values())

    shared = (f"; shared MHA block every {cfg.attn_every} layers "
              f"({cfg.n_layers // cfg.attn_every} rounds): {cfg.n_heads} "
              f"heads x {cfg.head_dim}, d_ff {cfg.d_ff}"
              if cfg.family == "hybrid" else "")
    log(f"{tag} {cfg.name}: {cfg.n_layers} Mamba2 layers, d_model "
        f"{cfg.d_model}, {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}{shared}, {cfg.dtype}; "
        f"{numel(params) / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.3f} s")
    half = prompt_len // 2
    prefill, decode = S.make_prefill_step(cfg), S.make_decode_step(cfg)

    with torch.no_grad():       # warm-up: library handles, kernel loading
        prefill(params, M.init_cache(cfg, batch, prompt_len, device=device),
                prompts)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    reset_launches()
    with torch.no_grad():
        last, toks, t_pre, t_dec = _greedy(cfg, params, prompts, n_new,
                                           device)
        cache = M.init_cache(cfg, batch, prompt_len, device=device)
        _sync(device)
        t1 = time.perf_counter()
        _, cache = prefill(params, cache, prompts[:, :half])
        pos = M.default_positions(batch, prompt_len, device=device)[:, half:]
        feed, cache = S.make_verify_step(cfg)(params, cache,
                                              prompts[:, half:], pos)
        _sync(device)
        t_feed = time.perf_counter() - t1
    launches = read_launches()
    want = expected_launches(cfg, 3, n_new)
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device == "cuda" else float("nan"))
    log(f"{tag} prefill {batch} x {prompt_len} tokens: {t_pre * 1e3:.3f} ms "
        f"({batch * prompt_len / t_pre:.1f} tokens/s); {n_new} decode steps "
        f"in {t_dec:.3f} s ({t_dec / n_new * 1e3:.3f} ms per step, "
        f"{batch * n_new / t_dec:.1f} tokens/s); chunked feed "
        f"{half} + {prompt_len - half}: {t_feed * 1e3:.3f} ms; peak "
        f"{peak:.2f} GiB allocated")
    log(f"{tag} launches {json.dumps(launches)}; expected "
        f"{json.dumps({k: v for k, v in want.items() if v})}")
    toks_ok = bool(((toks >= 0) & (toks < cfg.vocab)).all())
    finite = bool(torch.isfinite(last.float()).all()
                  and torch.isfinite(feed.float()).all())
    fl = feed[:, -1].float()
    atol, rtol = TOL[str(last.dtype)]
    feed_close = _close(fl, last, atol, rtol)
    log(f"{tag} chunked feed vs one-shot prefill, last-position logits: "
        f"cosine {_cosine(fl, last):.6f}, max|diff| "
        f"{float((fl - last.float()).abs().max()):.5f} (|logit| <= "
        f"{float(last.float().abs().max()):.3f}); within atol=rtol="
        f"{atol}: {feed_close}; argmax equal "
        f"{bool((fl.argmax(-1) == last.argmax(-1)).all())}")

    # the plain path (ssd_chunked, blocked attention), not counted
    plain_last, _ = plain_floor(cfg, params, prompts)
    plain_cos = _cosine(last, plain_last)
    log(f"{tag} prefill, kernel vs plain path: cosine {plain_cos:.6f}, "
        f"max|diff| {float((last.float() - plain_last.float()).abs().max()):.5f}"
        f"; gate {plain_gate}")
    round_checks = {}
    if cfg.family == "hybrid":
        if last.dtype == torch.bfloat16:
            log(f"{tag} {cfg.n_layers} layers: prefill, plain path with P "
                f"rounded to bf16 before P.V (the kernel's rounding) vs "
                f"plain: cosine "
                f"{bf16_p_witness(cfg, params, prompts, plain_last):.6f}")
        # one round (attn_every Mamba2 layers, the shared block once): the
        # plain floor, the kernel-vs-plain gate, the witness
        one = cfg.replace(n_layers=cfg.attn_every)
        k1 = _prefill_last(one, params, prompts)
        p1, floors1 = plain_floor(one, params, prompts)
        cos1 = _cosine(k1, p1)
        log(f"{tag} 1 round ({one.n_layers} layers): prefill, kernel vs "
            f"plain path: cosine {cos1:.6f}, max|diff| "
            f"{float((k1.float() - p1.float()).abs().max()):.5f} (|logit| "
            f"<= {float(p1.float().abs().max()):.3f}); gate "
            f"{HYBRID_ROUND_GATE}")
        if k1.dtype == torch.bfloat16:
            log(f"{tag} 1 round: plain path with P rounded to bf16 vs "
                f"plain: cosine {bf16_p_witness(one, params, prompts, p1):.6f}")
        round_checks = {
            f"1 round: plain floor >= {HYBRID_ROUND_GATE}":
                min(floors1.values()) >= HYBRID_ROUND_GATE,
            f"1 round: kernel vs plain cosine >= {HYBRID_ROUND_GATE}":
                cos1 >= HYBRID_ROUND_GATE}
        del k1, p1

    # profiled windows: the prefill, then 4 decode steps on its cache
    cache = M.init_cache(cfg, batch, prompt_len + 4, device=device)
    tok = toks[:, :1]

    def prefill_window():
        with torch.no_grad():
            prefill(params, cache, prompts)

    def decode_window():
        with torch.no_grad():
            for i in range(4):
                pos = torch.full((batch, 1), prompt_len + i,
                                 dtype=torch.int32, device=device)
                decode(params, cache, tok, pos)

    if device == "cuda":
        for label, fn in (("prefill", prefill_window),
                          ("4 decode steps", decode_window)):
            prof = profile_device_share(fn)
            if prof is None:
                log(f"{tag} profiler ({label}): no device time reported "
                    f"(device share not measured)")
                continue
            pw, busy, top = prof
            log(f"{tag} profiled {label}: wall {pw:.3f} s, kernel time "
                f"{busy:.3f} s, device busy share {busy / pw:.3f}")
            for name, sec, calls in top[:5]:
                log(f"{tag}   {sec:8.4f} s {calls:7d} calls  {name[:90]}")
            # the port's kernels, wherever they rank
            for name, sec, calls in top:
                if any(k in name for k in SSD_KERNEL_SYMBOLS
                       + PORT_KERNEL_SYMBOLS):
                    log(f"{tag}   port kernel: {sec:8.4f} s {calls:7d} "
                        f"calls  {name[:90]}")
    n_ops, n_launches, top_ops = profile_host_ops(decode_window)
    log(f"{tag} host, per decode step: {n_ops / 4:.0f} operator calls "
        f"({n_ops / 4 / cfg.n_layers:.0f} per Mamba2 layer), "
        f"{n_launches / 4:.0f} kernel launches "
        f"({n_launches / 4 / cfg.n_layers:.0f} per Mamba2 layer); by self "
        f"CPU time over 4 steps: "
        + json.dumps([(k, round(t, 4), c) for k, t, c in top_ops]))
    del params, cache
    if device == "cuda":
        torch.cuda.empty_cache()

    # ``tiny`` in float32: kernel and plain greedy streams
    tiny = tiny.replace(dtype="float32")
    tiny_p = M.init_params(tiny, seed=1, device=device)
    tiny_prompts = torch.from_numpy(
        np.random.default_rng(7).integers(1, tiny.vocab, (2, 40))).to(device)
    streams = {}
    for impl in ("pallas", "blocked"):
        reset_launches()
        with torch.no_grad():
            _, t, _, _ = _greedy(tiny.replace(attn_impl=impl), tiny_p,
                                 tiny_prompts, 16, device)
        streams[impl] = (t.tolist(), read_launches())
    del tiny_p
    tiny_want = expected_launches(tiny, 1, 16)
    log(f"{tag} {tiny.name} ({tiny.n_layers} Mamba2 layers, d_model "
        f"{tiny.d_model}, f32): kernel stream == plain stream: "
        f"{streams['pallas'][0] == streams['blocked'][0]}; kernel path "
        f"launches {json.dumps({k: v for k, v in streams['pallas'][1].items() if v})}")

    checks = {
        "tokens in the vocab": toks_ok,
        "finite logits": finite,
        "launches as expected": launches == want,
        "chunked feed agrees with the one-shot prefill": feed_close,
        f"tiny f32 streams identical":
            streams["pallas"][0] == streams["blocked"][0],
        "tiny kernel path launches as expected":
            streams["pallas"][1] == tiny_want,
        "tiny plain path launched nothing":
            not any(streams["blocked"][1].values()),
        **round_checks,
    }
    if plain_gate is not None:
        checks[f"kernel vs plain cosine >= {plain_gate}"] = \
            plain_cos >= plain_gate
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"{cfg.family} full-width run failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the MoE family at full width
# ---------------------------------------------------------------------------

# (config, layers kept): whole, the two are ~470 GB and ~800 GB in bf16,
# so each keeps every width as published and is cut in depth to fit the
# card: qwen3-moe to 8 of its 94 layers (39.40 GiB of weights),
# llama4-maverick to one round of its 24 -- a dense layer, then an MoE
# layer with the shared expert -- (34.56 GiB; the round's 128 experts
# alone are 32.2 GB)
MOE_CONFIGS = [("qwen3-moe-235b-a22b", 8), ("llama4-maverick-400b-a17b", 2)]
# the float32 check at 2 layers keeps every width; llama4's 128 experts
# would be ~66 GB in f32 there, so it keeps 16
MOE_F32_EXPERTS = {"llama4-maverick-400b-a17b": 16}
# the prefill-logits gate, kernels vs plain with the plain path routed as
# the kernels chose (PERF.md section 6, PR 20): each path routing itself,
# a rounding difference flips experts, and the kernel path's bf16 P moves
# the logits more than the plain floor's f32 reordering does
MOE_COSINE_GATE = 0.999
# profiler range names of the MoE layers' device work
MOE_RANGES = ("moe_ffn", "grouped_ffn")


class moe_ranges:
    """While active, every ``moe_ffn`` call and, inside it, the experts'
    products (``grouped_ffn``) run under a ``record_function`` range of
    that name, so the profiler can attribute their kernels."""

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.models import layers as L
        self.saved = {n: getattr(L, n) for n in MOE_RANGES}

        def ranged(name, fn):
            def call(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return call

        for n, fn in self.saved.items():
            setattr(L, n, ranged(n, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        for n, fn in self.saved.items():
            setattr(L, n, fn)
        return False


def profile_moe_step(fn):
    """Run ``fn`` under torch.profiler (host and device) with the MoE
    ranges on.  Returns a dict: wall s, summed kernel s, the port's
    attention kernels' s, the device s of the ``moe_ffn`` and
    ``grouped_ffn`` ranges, host syncs (``cudaStreamSynchronize``) in
    all and inside a ``moe_ffn`` range, ``cudaMemcpyAsync`` calls (any
    direction) and kernel launches; None when the profiler reports no
    device time.  The profiler slows the host, so the busy share is a
    lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with moe_ranges(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = prof.events()
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and e.name not in MOE_RANGES]
    if not kernels:
        return None

    def dev_s(e):
        us = (e.device_time_total if hasattr(e, "device_time_total")
              else e.cuda_time_total)
        return us / 1e6

    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    moe = [e.time_range for e in cpu if e.name == "moe_ffn"]
    syncs = [e.time_range for e in cpu if e.name == "cudaStreamSynchronize"]
    return dict(
        wall_s=wall,
        kernel_s=sum(e.time_range.elapsed_us() for e in kernels) / 1e6,
        attention_s=sum(e.time_range.elapsed_us() for e in kernels
                        if any(k in e.name for k in PORT_KERNEL_SYMBOLS))
        / 1e6,
        **{f"{n}_s": sum(dev_s(e) for e in cpu if e.name == n)
           for n in MOE_RANGES},
        syncs=len(syncs),
        syncs_in_moe_ffn=sum(any(m.start <= t.start and t.end <= m.end
                                 for m in moe) for t in syncs),
        memcpys=sum(e.name == "cudaMemcpyAsync" for e in cpu),
        launches=sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                     for e in cpu))


def _engine_streams(eng, prompts, max_new):
    import torch
    from repro_torch.serving import synergy as SY
    with torch.no_grad():
        return SY.run_cloud_centric(eng, prompts, max_new)


def _free(device):
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def phase_moe_configs(configs=MOE_CONFIGS, device="cuda"):
    """Each MoE config of the reference at full width, cut in depth, in
    bf16 with random weights from a seed: ``run_cloud_centric`` on phase
    8's four prompts (64-256 tokens, 16 new tokens each) on a dense
    ``CloudEngine`` (both dense attention kernels launched, nothing
    else) and on a paged one with prefix sharing (both paged kernels,
    nothing else; no leaked block).  The prefill logits are held against
    the plain (blocked) attention path with the plain path routed as the
    kernel path chose (cosine >= 0.999, after the plain floor, naive vs
    blocked routed so, clears it); each path routing itself, the cosine
    is logged (a flipped expert moves it far).  Every engine also
    launches ``grouped_mm`` (the experts' products) and no other kernel.
    One engine decode step and the 256-token prefill run under the
    profiler: busy share, launches, host syncs (none inside ``moe_ffn``),
    and the kernel time of the experts' products against the attention
    kernels; one decode step runs with its ``moe_ffn`` calls under
    ``set_sync_debug_mode("error")``.  At 2 layers in float32 the
    streams through the kernels and the plain path, dense and paged, must
    be identical.  Frees each config before the next.  Returns the summed
    ``grouped_mm`` launches of the ``run_cloud_centric`` runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import splits as SP
    from repro_torch.models import model as M
    from repro_torch.serving.engine import CloudEngine

    checks, moe_launches = {}, 0
    sms = SP.sm_count(torch.device(device)) if device == "cuda" else \
        SP.SM_COUNT
    paged_kw = dict(cache_impl="paged", block_size=16, share_prefix=True)
    for name, depth in configs:
        full = get_config(name)
        cfg = full.replace(attn_impl="pallas", n_layers=depth)
        g = cfg.n_heads // cfg.n_kv_heads
        n_moe = (depth if cfg.moe_every == 1 else depth // cfg.moe_every)
        _free(device)
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed=0, device=device)
        _sync(device)
        log(f"[moe] {name}: {depth} of {full.n_layers} layers ({n_moe} MoE; "
            f"cut: the whole model does not fit one card), widths as "
            f"published: d_model {cfg.d_model}, {cfg.n_heads} heads / "
            f"{cfg.n_kv_heads} kv (g {g}) x {cfg.head_dim}, {cfg.n_experts} "
            f"experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, moe_every "
            f"{cfg.moe_every}, shared {cfg.n_shared_experts}, vocab "
            f"{cfg.vocab}; {_weights_gib(params):.2f} GiB of bf16 weights; "
            f"init {time.perf_counter() - t0:.2f} s")
        prompts = dense_prompts(cfg.vocab)
        shas = {}
        for layout, kw, path in (("dense", {}, DENSE_PATH[:2] + MOE_PATH),
                                 ("paged", paged_kw, PAGED_PATH + MOE_PATH)):
            eng = CloudEngine(cfg, params, max_slots=DENSE_SLOTS,
                              s_max=DENSE_S_MAX, device=device, **kw)
            _engine_streams(eng, prompts[:1], 2)   # warm-up
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            reset_launches()
            _sync(device)
            t0 = time.perf_counter()
            res = _engine_streams(eng, prompts, DENSE_MAX_NEW)
            _sync(device)
            wall = time.perf_counter() - t0
            launches = read_launches()
            moe_launches += launches["grouped_mm"]
            n_tok = sum(len(o) for o in res.outputs)
            peak = (torch.cuda.max_memory_allocated() / 2**30
                    if device == "cuda" else float("nan"))
            shas[layout] = outputs_sha(res.outputs)
            log(f"[moe] {name} {layout}: run_cloud_centric, {len(prompts)} "
                f"prompts, {n_tok} tokens in {wall:.3f} s wall "
                f"({n_tok / wall:.2f} tokens/s); sha {shas[layout]}; peak "
                f"{peak:.2f} GiB allocated; launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}")
            checks[f"{name} {layout}: outputs"] = all(
                len(o) == DENSE_MAX_NEW and all(0 <= t < cfg.vocab for t in o)
                for o in res.outputs)
            checks[f"{name} {layout}: {', '.join(path)} launched, nothing "
                   f"else"] = (all(launches[k] > 0 for k in path) and all(
                       v == 0 for k, v in launches.items() if k not in path))
            if layout == "paged":
                a = eng.allocator
                pool = eng.pool_stats
                log(f"[moe] {name} paged: pool " + json.dumps(
                    {k: pool[k] for k in ("n_blocks", "peak_used_blocks",
                                          "dedupe_hit_blocks",
                                          "kv_cache_bytes")})
                    + f"; streams equal to the dense engine's: "
                    f"{shas['paged'] == shas['dense']}")
                checks[f"{name} paged: no leaked block"] = (
                    a.used_blocks == 0
                    and a.free_blocks + a.cached_blocks == a.n_blocks)
            else:
                grids = {f"prefill C={c}": SP.dense_grid(
                    DENSE_SLOTS, cfg.n_kv_heads, g * c, DENSE_S_MAX,
                    decode=False, sms=sms)
                    for c in eng.compile_stats["buckets"]}
                grids["decode"] = SP.dense_grid(
                    DENSE_SLOTS, cfg.n_kv_heads, g, DENSE_S_MAX, decode=True,
                    sms=sms)
                log(f"[moe] {name}: splits / grid: " + json.dumps(grids))
                if device == "cuda":
                    checks.update(profile_moe_engine(name, eng, prompts[-1],
                                                     n_moe))
            del eng
            _free(device)

        # prefill logits, kernels vs plain attention: each path routing
        # itself (logged), and the plain path routed as the kernel path
        # chose (gated, once its own floor clears the gate)
        cos = prefill_cosines(cfg, params, prompts, device)
        for label, vals in cos.items():
            log(f"[moe] {name}: prefill logits, {label}: cosine per prompt "
                f"{[round(c, 6) for c in vals]}")
        for label in ("plain floor, routing pinned",
                      "kernel vs plain, routing pinned"):
            checks[f"{name}: {label} >= {MOE_COSINE_GATE}"] = \
                min(cos[label]) >= MOE_COSINE_GATE
        del params
        _free(device)

        # 2 layers at full width in float32: kernel vs plain streams, and
        # the dense vs the paged engine
        c32 = cfg.replace(n_layers=2, dtype="float32",
                          n_experts=MOE_F32_EXPERTS.get(name, cfg.n_experts))
        p32 = M.init_params(c32, seed=1, device=device)
        f32 = {}
        for label, impl, kw in (("dense kernels", "pallas", {}),
                                ("dense plain", "blocked", {}),
                                ("paged kernels", "pallas", paged_kw)):
            eng = CloudEngine(c32.replace(attn_impl=impl), p32,
                              max_slots=DENSE_SLOTS, s_max=DENSE_S_MAX,
                              device=device, **kw)
            f32[label] = outputs_sha(_engine_streams(
                eng, prompts, DENSE_MAX_NEW).outputs)
            del eng
        log(f"[moe] {name}: 2 layers f32 ({c32.n_experts} experts), stream "
            f"shas {json.dumps(f32)}")
        checks[f"{name}: f32 streams identical (kernels, plain, paged)"] = \
            len(set(f32.values())) == 1
        del p32
        _free(device)
    failed = [k for k, v in checks.items() if not v]
    log("[moe] checks: " + json.dumps(checks))
    if failed:
        raise RuntimeError(f"MoE phase failed: {failed}")
    return {"grouped_mm": moe_launches}


class pinned_routing:
    """While active, record the expert choices of every ``moe_route`` call
    or, given an earlier pass's record, route each call in order to the
    experts recorded there, weighted by this pass's own probabilities.
    Two paths compared this way differ by their attention and products
    alone, not by an expert that a rounding difference flipped."""

    def __init__(self, replay=None):
        self.choices = []
        self.replay = None if replay is None else list(replay)

    def __enter__(self):
        import torch
        from repro_torch.models import layers as L
        self.saved = route = L.moe_route

        def pinned(router, xf, top_k):
            if self.replay is None:
                probs, top_p, top_e = route(router, xf, top_k)
                self.choices.append(top_e)
                return probs, top_p, top_e
            probs = torch.softmax(xf.float() @ router, dim=-1)
            top_e = self.replay.pop(0)
            top_p = probs.gather(1, top_e)
            return probs, top_p / top_p.sum(-1, keepdim=True), top_e

        L.moe_route = pinned
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.moe_route = self.saved
        return False


def prefill_cosines(cfg, params, prompts, device):
    """Per prompt, cosines of the prefill logits (``cfg`` routes with
    ``moe_route``): the kernel path against the plain (blocked) path and
    the plain floor (naive vs blocked), each path routing itself; the
    same two with every plain pass routed as the kernel pass chose; and,
    routed so, the witness: blocked attention with P rounded to bf16
    before P.V, as the bf16 prefill kernel rounds it."""
    import torch
    from unittest import mock
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    def run(impl, replay=None, witness=False):
        with pinned_routing(replay) as rec, mock.patch.object(
                L, "blocked_attention",
                _blocked_bf16_p if witness else L.blocked_attention):
            out = M.forward(cfg.replace(attn_impl=impl), params, toks,
                            pos)[0]
        return out, rec.choices

    cos = {k: [] for k in (
        "kernel vs plain", "plain floor (naive vs blocked)",
        "kernel vs plain, routing pinned", "plain floor, routing pinned",
        "bf16-P witness vs plain, routing pinned")}
    with torch.no_grad():
        for p in prompts:
            toks = torch.tensor([p], device=device)
            pos = M.default_positions(1, len(p), device=device)
            lk, chosen = run("pallas")
            lp, ln = run("blocked")[0], run("naive")[0]
            cos["kernel vs plain"].append(_cosine(lk, lp))
            cos["plain floor (naive vs blocked)"].append(_cosine(ln, lp))
            del lp, ln
            lp = run("blocked", chosen)[0]
            ln = run("naive", chosen)[0]
            lw = run("blocked", chosen, witness=True)[0]
            cos["kernel vs plain, routing pinned"].append(_cosine(lk, lp))
            cos["plain floor, routing pinned"].append(_cosine(ln, lp))
            cos["bf16-P witness vs plain, routing pinned"].append(
                _cosine(lw, lp))
            del lk, lp, ln, lw
    return cos


# host syncs of a decode step while moe_ffn read its group sizes to the
# host (PERF.md section 5): qwen3-moe at 8 layers
HOST_READ_DECODE_SYNCS = {"qwen3-moe-235b-a22b": 14}


def sync_free_moe(eng, td, pd):
    """One engine decode step of ``eng`` with every ``moe_ffn`` call in it
    under ``torch.cuda.set_sync_debug_mode("error")`` (the rest of the
    step -- the cache-write index, the sampled rows' host copy -- reads
    the card as before).  Returns (MoE calls, None) when no MoE layer
    waited for the device, else (calls, the error)."""
    import torch
    from repro_torch.models import layers as L
    inner, calls = L.moe_ffn, []

    def strict(*a, **k):
        calls.append(1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    L.moe_ffn = strict
    try:
        eng.decode(td, pd)
        err = None
    except RuntimeError as e:
        err = str(e)[:300]
    finally:
        L.moe_ffn = inner
    return len(calls), err


def profile_moe_engine(name, eng, prompt, n_moe):
    """Profile one 256-token prefill and one decode step of ``eng`` (slot
    0, the other slots idle) and log their busy share, launches, host
    syncs (in all, the engine's own reads; none inside ``moe_ffn``) and
    the kernel time of the experts' products against the attention
    kernels; then run one decode step with its MoE layers under the sync
    debug mode.  Returns the checks."""
    B = eng.max_slots
    tokens = np.zeros((B, len(prompt)), np.int32)
    positions = np.full((B, len(prompt)), -1, np.int32)
    tokens[0], positions[0] = prompt, np.arange(len(prompt))
    td = np.zeros((B, 1), np.int32)
    pd = np.full((B, 1), -1, np.int32)
    td[0, 0], pd[0, 0] = prompt[-1], len(prompt)
    checks = {}
    for label, fn in ((f"prefill T={len(prompt)}",
                       lambda: eng.prefill(tokens, positions)),
                      ("decode step", lambda: eng.decode(td, pd))):
        reset_launches()
        prof = profile_moe_step(fn)
        port = {k: v for k, v in read_launches().items() if v}
        if prof is None:
            log(f"[moe] {name} {label}: profiler reported no device time "
                f"(not measured)")
            continue
        k = prof["kernel_s"]
        was = (f" ({HOST_READ_DECODE_SYNCS[name]} with the group sizes "
               f"read to the host)" if label == "decode step"
               and name in HOST_READ_DECODE_SYNCS else "")
        log(f"[moe] {name} {label}: wall {prof['wall_s']:.4f} s, kernels "
            f"{k:.4f} s, busy share {k / prof['wall_s']:.3f}; kernel "
            f"launches {prof['launches']} (port kernels {json.dumps(port)});"
            f" host syncs {prof['syncs']}{was}, inside moe_ffn "
            f"{prof['syncs_in_moe_ffn']} ({n_moe} MoE layers), memcpy "
            f"calls {prof['memcpys']}; moe_ffn {prof['moe_ffn_s']:.4f} s, of "
            f"it grouped_ffn (expert GEMMs) {prof['grouped_ffn_s']:.4f} s "
            f"({prof['grouped_ffn_s'] / k:.3f} of kernel time); attention "
            f"kernels {prof['attention_s']:.5f} s "
            f"({prof['attention_s'] / k:.4f})")
        checks[f"{name} {label}: no host sync inside moe_ffn"] = (
            prof["syncs_in_moe_ffn"] == 0)
    calls, err = sync_free_moe(eng, td, pd)
    log(f"[moe] {name}: a decode step's {calls} moe_ffn calls under "
        f"set_sync_debug_mode('error'): "
        f"{'nothing raised' if err is None else err}")
    checks[f"{name}: a decode step's moe_ffn calls raise nothing under "
           f"sync debug mode 'error'"] = err is None and calls == n_moe
    eng.reset_slot(0)
    return checks


# ---------------------------------------------------------------------------
# Phase 11: the vlm and audio families at full width
# ---------------------------------------------------------------------------

# (config, layers kept or None for all): whisper-medium whole (24 encoder
# and 24 decoder layers); llama-3.2-vision-90b is ~163 GiB in bf16 whole,
# so it keeps two of its 20 rounds -- 10 of 100 layers, 8 self-attention
# and 2 cross-attention -- every width as published
CROSS_CONFIGS = [("whisper-medium", None), ("llama-3.2-vision-90b", 10)]
# the vlm's cross-layer gates: they initialise to 0, and tanh(0) = 0 makes
# every cross layer a no-op, so the phase sets them after init
CROSS_GATE = 0.5
# the model-level run: 4 prompts of CROSS_PROMPT tokens, the first
# CROSS_PREFIX prefilled (then CROSS_NEW decode steps), the last
# CROSS_CHUNK fed as a verify chunk over the cached prefix; caches of
# DENSE_S_MAX slots, as the engine's
CROSS_PROMPT, CROSS_CHUNK, CROSS_NEW = 256, 8, 32
CROSS_PREFIX = CROSS_PROMPT - CROSS_CHUNK
CROSS_COSINE_GATE = 0.999
# the verify chunk against the full forward.  In bf16 a 1-ulp difference
# of a hidden state (the chunk's 32-row GEMMs against the forward's
# 1,024-row ones, another split of the attention) moves single logits by
# ~0.1 (PERF.md section 6), as the plain path's own floor shows,
# so the elementwise bf16 tolerance gates only where the plain path's
# chunk clears it; the cosine is gated always, and at full width in
# float32 the chunk must agree within the model-level f32 tolerance of
# the CPU parity tests (MODEL_TOL there)
CROSS_F32_TOL = (1e-4, 1e-4)


def self_attention_layers(cfg) -> int:
    """The causal self-attention layers of a vlm or audio model (the ones
    that reach the attention kernels; the cross-attention and the audio
    encoder are non-causal and take the plain path)."""
    if cfg.family == "vlm":
        return (cfg.n_layers // cfg.cross_attn_every
                * (cfg.cross_attn_every - 1))
    return cfg.n_layers


def cross_launches(cfg, n_forwards, n_decode):
    """Exact kernel launches of ``n_forwards`` multi-token forwards and
    ``n_decode`` decode steps of a vlm or audio model on its kernel path:
    one ``partial_prefill_attention`` or ``decode_attention`` per causal
    self-attention layer; nothing else."""
    n = self_attention_layers(cfg)
    want = {k: 0 for k in kernel_modules()}
    want.update(partial_prefill_attention=n_forwards * n,
                decode_attention=n_decode * n)
    return want


def cross_inputs(cfg, batch, device, seed=11):
    """Phase 11's stub frontend output on the card from a seeded
    generator, in the model's dtype: the vlm's image embeds (batch,
    n_image_tokens, vision_dim), the audio family's frames (batch,
    n_audio_frames, d_model)."""
    import torch
    from repro_torch.models import model as M
    g = torch.Generator(device=device).manual_seed(seed)
    src = ((cfg.n_image_tokens, cfg.vision_dim) if cfg.family == "vlm"
           else (cfg.n_audio_frames, cfg.d_model))
    x = torch.randn((batch, *src), generator=g, device=device)
    return {M.AUX_INPUTS[cfg.family]: x.to(M.torch_dtype(cfg))}


def cross_params(cfg, seed, device):
    """Random weights from a seed; a vlm's cross-layer gates set to
    ``CROSS_GATE``."""
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed=seed, device=device)
    if cfg.family == "vlm":
        for key in ("gate_attn", "gate_ffn"):
            params["cross_layers"][key].fill_(CROSS_GATE)
    return params


def _verify_chunk(cfg, params, prompts, aux, device):
    """Prefill the first ``CROSS_PREFIX`` tokens with ``aux`` (the cross
    cache filled), then feed the last ``CROSS_CHUNK`` through the verify
    step.  Returns (chunk logits, cross cache unchanged by the verify)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    B = prompts.shape[0]
    cache = M.init_cache(cfg, B, DENSE_S_MAX, device=device)
    _, cache = S.make_prefill_step(cfg)(params, cache,
                                        prompts[:, :CROSS_PREFIX], aux)
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    pos = M.default_positions(B, CROSS_PROMPT, device=device)[:, CROSS_PREFIX:]
    chunk, cache = S.make_verify_step(cfg)(params, cache,
                                           prompts[:, CROSS_PREFIX:], pos)
    kept = all(torch.equal(cache["cross"][k], cross[k]) for k in cross)
    return chunk, kept


def phase_cross_configs(configs=CROSS_CONFIGS, device="cuda"):
    """The reference's vlm and audio configs at published widths in bf16,
    random weights from a seed (the vlm's gates set to 0.5), stub image
    embeds and audio frames from a seeded generator.  Main path, counted,
    through the model-level steps: a batched prefill of 4 x 248 tokens
    with the aux inputs (filling the cross cache), 32 greedy decode steps
    over it, and on a fresh cache the same prefill then an 8-token verify
    chunk, which must leave the cross cache as it was and agree with the
    full forward over the 256 tokens (cosine >= 0.999; within the bf16
    tolerance where the plain path's own chunk is); the launches must
    equal :func:`cross_launches` exactly.  Then, uncounted:
    the full forward's logits through the kernels against the plain
    (blocked) path, gated at cosine >= 0.999 where the plain floor (naive
    vs blocked) clears it; ``run_cloud_centric`` on a dense
    ``CloudEngine`` on phase 8's four prompts (its steps never fill the
    cross cache, as the reference serves these families: both dense
    kernels, nothing else); one profiled prefill and decode step; and in
    float32 (whisper at 2 + 2 layers, vision at one round, full width)
    identical greedy streams through the kernels and the plain path, and
    the verify chunk within ``CROSS_F32_TOL`` of the full forward.
    Frees each config before the next."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.serving.engine import CloudEngine

    checks = {}
    for name, depth in configs:
        full = get_config(name)
        cfg = full.replace(attn_impl="pallas")
        if depth is not None:
            cfg = cfg.replace(n_layers=depth)
        n_self = self_attention_layers(cfg)
        tag = f"[{cfg.family}] {name}"
        _free(device)
        t0 = time.perf_counter()
        params = cross_params(cfg, 0, device)
        _sync(device)
        if cfg.family == "vlm":
            rounds = cfg.n_layers // cfg.cross_attn_every
            shape = (f"{rounds} of {full.n_layers // full.cross_attn_every} "
                     f"rounds, {cfg.n_layers} of {full.n_layers} layers "
                     f"({n_self} self, {rounds} cross; cut: the whole model "
                     f"does not fit one card), widths as published; "
                     f"{cfg.n_image_tokens} image tokens of "
                     f"{cfg.vision_dim}, gates {CROSS_GATE}")
        else:
            shape = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} "
                     f"decoder layers (whole), {cfg.n_audio_frames} frames")
        log(f"{tag}: {shape}; d_model {cfg.d_model}, {cfg.n_heads} heads / "
            f"{cfg.n_kv_heads} kv x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab}; {_weights_gib(params):.2f} GiB of bf16 weights; "
            f"init {time.perf_counter() - t0:.2f} s")
        aux = cross_inputs(cfg, DENSE_SLOTS, device)
        prompts = torch.from_numpy(np.random.default_rng(11).integers(
            1, cfg.vocab, (DENSE_SLOTS, CROSS_PROMPT))).to(device)
        with torch.no_grad():       # warm-up: library handles, allocator
            _greedy(cfg, params, prompts[:, :CROSS_PREFIX], 1, device,
                    aux_inputs=aux, s_max=DENSE_S_MAX)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()

        reset_launches()
        with torch.no_grad():
            last, toks, t_pre, t_dec = _greedy(
                cfg, params, prompts[:, :CROSS_PREFIX], CROSS_NEW, device,
                aux_inputs=aux, s_max=DENSE_S_MAX)
            chunk, kept = _verify_chunk(cfg, params, prompts, aux, device)
            _sync(device)
        launches = read_launches()
        want = cross_launches(cfg, 3, CROSS_NEW)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else float("nan"))
        B = DENSE_SLOTS
        key = M.AUX_INPUTS[cfg.family]
        log(f"{tag}: prefill {B} x {CROSS_PREFIX} tokens with {key} "
            f"{tuple(aux[key].shape)}: {t_pre * 1e3:.3f} ms; {CROSS_NEW} decode steps in "
            f"{t_dec:.3f} s ({t_dec / CROSS_NEW * 1e3:.3f} ms per step, "
            f"{B * CROSS_NEW / t_dec:.1f} tokens/s); peak {peak:.2f} GiB "
            f"allocated")
        log(f"{tag}: launches {json.dumps(launches)}; expected "
            f"{json.dumps({k: v for k, v in want.items() if v})}")

        # the full forward over the 256 tokens: the verify chunk's oracle,
        # and the kernel-vs-plain prefill logits with the plain floor
        with torch.no_grad():
            pos = M.default_positions(B, CROSS_PROMPT, device=device)
            lk, lp, ln = (M.forward(cfg.replace(attn_impl=impl), params,
                                    prompts, pos, aux_inputs=aux)[0]
                          for impl in ("pallas", "blocked", "naive"))
        # the plain path's own chunk against its own full forward: the
        # floor under the elementwise bf16 check
        with torch.no_grad():
            chunk_p, _ = _verify_chunk(cfg.replace(attn_impl="blocked"),
                                       params, prompts, aux, device)
        atol, rtol = TOL[str(chunk.dtype)]
        ver = {}
        for label, c, f in (("kernel", chunk, lk), ("plain", chunk_p, lp)):
            tail = f[:, CROSS_PREFIX:]
            ver[label] = (_cosine(c, tail), _close(c, tail, atol, rtol))
            log(f"{tag}: verify chunk of {CROSS_CHUNK} over {CROSS_PREFIX} "
                f"cached vs the full forward, {label} path: cosine "
                f"{ver[label][0]:.6f}, max|diff| "
                f"{float((c.float() - tail.float()).abs().max()):.5f} "
                f"(|logit| <= {float(tail.float().abs().max()):.3f}); "
                f"within atol=rtol={atol}: {ver[label][1]}")
        log(f"{tag}: cross cache unchanged by the verify: {kept}")
        del chunk_p, tail
        cos, floor = _cosine(lk, lp), _cosine(ln, lp)
        gated = floor >= CROSS_COSINE_GATE
        log(f"{tag}: full-forward logits ({B} x {CROSS_PROMPT}), kernel vs "
            f"plain cosine {cos:.6f}; plain floor (naive vs blocked) "
            f"{floor:.6f}; gate {CROSS_COSINE_GATE} "
            f"{'applied' if gated else 'not applied (floor below it)'}")
        del lk, lp, ln
        checks.update({
            f"{name}: tokens in the vocab": bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()),
            f"{name}: finite logits": bool(
                torch.isfinite(last.float()).all()
                and torch.isfinite(chunk.float()).all()),
            f"{name}: launches as expected": launches == want,
            f"{name}: verify chunk vs full forward cosine >= "
            f"{CROSS_COSINE_GATE}": ver["kernel"][0] >= CROSS_COSINE_GATE,
            f"{name}: verify leaves the cross cache": kept,
        })
        if ver["plain"][1]:
            checks[f"{name}: verify chunk within bf16 {atol} of the full "
                   f"forward"] = ver["kernel"][1]
        if gated:
            checks[f"{name}: kernel vs plain cosine >= "
                   f"{CROSS_COSINE_GATE}"] = cos >= CROSS_COSINE_GATE

        # the engine: run_cloud_centric (cross cache never filled)
        eng = CloudEngine(cfg, params, max_slots=DENSE_SLOTS,
                          s_max=DENSE_S_MAX, device=device)
        eprompts = dense_prompts(cfg.vocab)
        _engine_streams(eng, eprompts[:1], 2)          # warm-up
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        res = _engine_streams(eng, eprompts, DENSE_MAX_NEW)
        _sync(device)
        wall = time.perf_counter() - t0
        elaunch = read_launches()
        n_tok = sum(len(o) for o in res.outputs)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else float("nan"))
        log(f"{tag}: engine run_cloud_centric, {len(eprompts)} prompts, "
            f"{n_tok} tokens in {wall:.3f} s wall ({n_tok / wall:.2f} "
            f"tokens/s); sha {outputs_sha(res.outputs)}; peak {peak:.2f} "
            f"GiB allocated; KV cache {eng.kv_cache_bytes() / 2**20:.1f} "
            f"MiB (self + cross); launches "
            f"{json.dumps({k: v for k, v in elaunch.items() if v})}")
        path = DENSE_PATH[:2]
        checks[f"{name}: engine outputs"] = all(
            len(o) == DENSE_MAX_NEW and all(0 <= t < cfg.vocab for t in o)
            for o in res.outputs)
        checks[f"{name}: engine launched {', '.join(path)}, nothing else"] = (
            all(elaunch[k] > 0 for k in path)
            and all(v == 0 for k, v in elaunch.items() if k not in path))
        del eng

        # one profiled prefill and decode step (model-level, slot-full)
        if device == "cuda":
            cache = M.init_cache(cfg, B, DENSE_S_MAX, device=device)
            prefill, decode = S.make_prefill_step(cfg), S.make_decode_step(cfg)
            tok = toks[:, :1]
            dpos = torch.full((B, 1), CROSS_PREFIX, dtype=torch.int32,
                              device=device)
            for label, fn in (
                    (f"prefill {B} x {CROSS_PREFIX}",
                     lambda: prefill(params, cache,
                                     prompts[:, :CROSS_PREFIX], aux)),
                    ("decode step", lambda: decode(params, cache, tok,
                                                   dpos))):
                reset_launches()
                with torch.no_grad():
                    prof = profile_moe_step(fn)
                port = {k: v for k, v in read_launches().items() if v}
                if prof is None:
                    log(f"{tag} {label}: profiler reported no device time "
                        f"(not measured)")
                    continue
                k = prof["kernel_s"]
                log(f"{tag} {label}: wall {prof['wall_s']:.4f} s, kernels "
                    f"{k:.4f} s, busy share {k / prof['wall_s']:.3f}; kernel "
                    f"launches {prof['launches']} (port kernels "
                    f"{json.dumps(port)}); host syncs {prof['syncs']}, "
                    f"memcpy calls {prof['memcpys']}; attention kernels "
                    f"{prof['attention_s']:.5f} s "
                    f"({prof['attention_s'] / k:.4f} of kernel time)")
            del cache
        del params, aux
        _free(device)

        # float32 at full width, cut in depth: kernel vs plain streams
        c32 = cfg.replace(dtype="float32", n_layers=(
            cfg.cross_attn_every if cfg.family == "vlm" else 2))
        if cfg.family == "audio":
            c32 = c32.replace(n_encoder_layers=2)
        p32 = cross_params(c32, 1, device)
        aux32 = cross_inputs(c32, DENSE_SLOTS, device)
        streams = {}
        for impl in ("pallas", "blocked"):
            reset_launches()
            with torch.no_grad():
                _, t, _, _ = _greedy(c32.replace(attn_impl=impl), p32,
                                     prompts[:, :CROSS_PREFIX], 16, device,
                                     aux_inputs=aux32, s_max=DENSE_S_MAX)
            streams[impl] = (t.tolist(), read_launches())
        depth32 = (f"{c32.n_layers} layers" if cfg.family == "vlm" else
                   f"{c32.n_encoder_layers} + {c32.n_layers} layers")
        used = {k: v for k, v in streams["pallas"][1].items() if v}
        log(f"{tag}: {depth32} f32: kernel stream == plain stream: "
            f"{streams['pallas'][0] == streams['blocked'][0]}; kernel path "
            f"launches {json.dumps(used)}")
        checks[f"{name}: f32 streams identical"] = \
            streams["pallas"][0] == streams["blocked"][0]
        checks[f"{name}: f32 kernel path launches as expected"] = \
            streams["pallas"][1] == cross_launches(c32, 1, 16)
        checks[f"{name}: f32 plain path launched nothing"] = \
            not any(streams["blocked"][1].values())
        # the verify chunk against the full forward, kernel path, in f32
        with torch.no_grad():
            chunk32, _ = _verify_chunk(c32, p32, prompts, aux32, device)
            pos = M.default_positions(B, CROSS_PROMPT, device=device)
            tail32 = M.forward(c32, p32, prompts, pos,
                               aux_inputs=aux32)[0][:, CROSS_PREFIX:]
        ok32 = _close(chunk32, tail32, *CROSS_F32_TOL)
        log(f"{tag}: {depth32} f32: verify chunk vs the full forward, "
            f"kernel path: max|diff| "
            f"{float((chunk32 - tail32).abs().max()):.3e} (|logit| <= "
            f"{float(tail32.abs().max()):.3f}); within atol=rtol="
            f"{CROSS_F32_TOL[0]}: {ok32}")
        checks[f"{name}: f32 verify chunk within {CROSS_F32_TOL[0]} of the "
               f"full forward"] = ok32
        del p32, aux32, chunk32, tail32
        _free(device)
    failed = [k for k, v in checks.items() if not v]
    log("[cross] checks: " + json.dumps(checks))
    if failed:
        raise RuntimeError(f"vlm/audio phase failed: {failed}")


# ---------------------------------------------------------------------------
# Phase 12: training
# ---------------------------------------------------------------------------

# 12a: the paper's 160M SLM whole; its corpus is cut to 8 of the
# reference's 64 sequences of 2,048 tokens (at vocab 32,000 the synthetic
# task draws ~3,000 tokens a second on one host core; 40 steps of 16 x 512
# draw from 8 x 2,048 as from 64 x 2,048)
TRAIN_160M = dict(steps=40, batch_size=16, seq_len=512)
TRAIN_160M_CORPUS = 8
# 12b: the 7B's widths at 4 of its 32 layers, two micro-batches
TRAIN_7B_LAYERS, TRAIN_7B_STEPS, TRAIN_7B_BATCH, TRAIN_7B_SEQ = 4, 5, 8, 512
# 12c: one reduced config per family, f32, card against host; mamba2
# under "pallas", where grad mode must pick the plain scan
TRAIN_PARITY = [("tiny-slm", "blocked"), ("qwen3-moe-235b-a22b", "blocked"),
                ("llama4-maverick-400b-a17b", "blocked"),
                ("mamba2-2.7b", "pallas"), ("zamba2-2.7b", "blocked"),
                ("whisper-medium", "blocked"),
                ("llama-3.2-vision-90b", "blocked")]
TRAIN_PARITY_BATCH = (2, 32)
# the CPU tests' tolerances (tests/test_torch_train.py): loss 1e-5
# relative, each gradient leaf 1e-4 of its largest |value|, parameters
# after one AdamW step 1e-5 wherever the gradient is resolved (above
# that 1e-4)
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_PARAM_ATOL = 1e-5, 1e-4, 1e-5
TRAIN_PARITY_LR = 3e-3
# 12d: the reference's benchmarks/prepare.py settings for the tiny pair
TINY_VOCAB, TINY_STEPS = 64, {"tiny-slm": 250, "tiny-llm": 400}


GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")


def kernel_kinds(rows):
    """Device seconds of profiler rows [(name, s, calls)] summed by kind:
    bf16 and f32 matrix products, elementwise, reductions, the rest."""
    kinds: dict[str, float] = {}
    for name, sec, _ in rows:
        n = name.lower()
        if any(m in n for m in GEMM_MARKS):
            kind = "f32 GEMM" if ("f32f32" in n or "sgemm" in n) \
                else "bf16 GEMM"
        elif "elementwise" in n:
            kind = "elementwise"
        elif "reduce" in n:
            kind = "reduction"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + sec
    return kinds


def train_flops(cfg, batch, seq):
    """Matrix-product FLOPs of one training step of a dense model, as the
    port runs it: (6 N tokens + attention forward and backward, the
    recompute of ``remat``).  N counts the layers' projections and the
    unembedding (the embedding is a gather); the blocked attention forms
    every (query, key) score of a T x T causal mask, 4 B T^2 nh hd a
    layer forward, 3x with backward; ``remat`` adds one layer forward
    (2 N_layers tokens + the attention forward again).  Returns
    (without the recompute, with it)."""
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_layer = d * nh * hd * 2 + 2 * d * nkv * hd + 3 * d * cfg.d_ff
    n = cfg.n_layers * n_layer + d * cfg.vocab
    tokens = batch * seq
    attn_fwd = cfg.n_layers * 4 * batch * seq * seq * nh * hd
    model = 6 * n * tokens + 3 * attn_fwd
    recompute = (2 * cfg.n_layers * n_layer * tokens + attn_fwd
                 if cfg.remat else 0)
    return model, model + recompute


def stacked_grad_ms(stack, n, reps=5):
    """Forward and backward ms of taking ``n`` layers out of a stacked
    parameter tree on the card: indexing each layer (one ``select`` per
    layer and leaf, whose backward allocates a zero tensor of the whole
    stack and adds into it) against one ``torch.unbind`` per leaf (one
    stack in backward).  Each layer's view is summed once (its gradient
    an expanded view: no kernel of its own).  Returns (select ms, unbind
    ms), medians."""
    import torch
    from repro_torch.tree import leaves
    xs = [t.detach().requires_grad_(True) for t in leaves(stack)]

    def run(split):
        parts = [split(x) for x in xs]
        loss = sum(p.sum().float() for ps in parts for p in ps)
        torch.autograd.grad(loss, xs)

    out = []
    for split in (lambda x: [x[i] for i in range(n)],
                  lambda x: x.unbind(0)[:n]):
        run(split)
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(split)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out.append(float(np.median(ts)) * 1e3)
    return tuple(out)


class step_timer:
    """While active, every step that ``repro_torch.launch.train`` makes
    through ``make_train_step`` is timed with the card synchronised
    before and after; the seconds land in ``self.seconds``."""

    def __init__(self):
        self.seconds = []

    def __enter__(self):
        import torch
        from repro_torch.launch import train as TR
        self._real = real = TR.make_train_step

        def factory(*a, **k):
            fn = real(*a, **k)

            def step(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
                return out
            return step

        TR.make_train_step = factory
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train as TR
        TR.make_train_step = self._real


def train_160m(device):
    """12a: ``launch.train.train`` on the paper's 160M SLM whole."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticTask, TaskSpec, batches
    from repro_torch.launch import train as TR
    from repro_torch.models import steps as S
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import leaves

    cfg = get_config("synera-slm-160m")
    t0 = time.perf_counter()
    corpus, _ = SyntheticTask(TaskSpec(vocab=cfg.vocab)).corpus(
        n_sequences=TRAIN_160M_CORPUS, length=2048, seed=0)
    corpus_s = time.perf_counter() - t0
    _free(device)
    torch.cuda.reset_peak_memory_stats()
    with step_timer() as timer:
        params, losses = TR.train(cfg, corpus=corpus, log_every=10,
                                  device=device, **TRAIN_160M)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = timer.seconds[3:]
    step_s = float(np.median(steady))
    B, T = TRAIN_160M["batch_size"], TRAIN_160M["seq_len"]
    tokens = B * T
    model_f, exec_f = train_flops(cfg, B, T)
    peak_flops = PEAK_FLOPS["torch.bfloat16"]
    n_params = sum(v.numel() for v in leaves(params))
    log(f"[train] 12a {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, remat {cfg.remat}; {n_params / 1e6:.1f}M params; "
        f"corpus {TRAIN_160M_CORPUS} x 2048 drawn in {corpus_s:.1f} s")
    log(f"[train] 12a losses: first {losses[0]:.4f}, last 5 mean "
        f"{np.mean(losses[-5:]):.4f}, all: "
        + " ".join(f"{x:.3f}" for x in losses))
    log(f"[train] 12a step ms (median of steps 4-{len(losses)}): "
        f"{step_s * 1e3:.2f}; first step {timer.seconds[0] * 1e3:.1f}; "
        f"min / max {min(steady) * 1e3:.2f} / {max(steady) * 1e3:.2f}; "
        f"tokens/s {tokens / step_s:.0f}; peak {peak:.2f} GiB")
    log(f"[train] 12a FLOPs a step: {model_f / 1e12:.3f} T (6 N tokens, N = "
        f"projections + unembedding, + causal attention fwd+bwd over the "
        f"full T x T scores), {exec_f / 1e12:.3f} T with remat's recompute "
        f"(one more layer forward); mfu {exec_f / (step_s * peak_flops):.4f} "
        f"(with the recompute) / {model_f / (step_s * peak_flops):.4f} "
        f"(without), against {peak_flops / 1e12:.0f} TFLOP/s dense bf16")

    # two more steps from the trained parameters, profiled
    opt = AdamW(lr=3e-3, weight_decay=0.01)
    step = S.make_train_step(cfg, opt)
    state = opt.init(params)
    it = batches(corpus, B, T, rng=np.random.default_rng(3))

    def two_steps():
        nonlocal params, state
        for _ in range(2):
            params, state, _ = step(params, state, {
                "tokens": torch.as_tensor(next(it), device=device)})

    two_steps()
    torch.cuda.synchronize()
    share = profile_device_share(two_steps)
    n_ops, n_launch, top = profile_host_ops(two_steps)
    torch.cuda.synchronize()
    if share is None:
        log("[train] 12a profile: the profiler reports no device time")
        busy = None
    else:
        wall, kern, rows = share
        busy = kern / wall
        kinds = kernel_kinds(rows)
        log(f"[train] 12a profile (2 steps): wall {wall * 1e3:.1f} ms, "
            f"kernels {kern * 1e3:.1f} ms, busy {busy:.3f}; kernel ms a "
            f"step by kind: " + ", ".join(
                f"{k} {v / 2 * 1e3:.2f}" for k, v in sorted(
                    kinds.items(), key=lambda kv: -kv[1])))
        log("[train] 12a top kernels (ms a step, calls a step): " + "; ".join(
            f"{n[:110]} {t / 2 * 1e3:.2f} x{c // 2}" for n, t, c in rows[:8]))
    log(f"[train] 12a host (2 steps): {n_ops / 2:.0f} aten calls and "
        f"{n_launch / 2:.0f} kernel launches a step; top host events: "
        + "; ".join(f"{n} {t * 1e3:.1f} ms x{c}" for n, t, c in top))
    sel, unb = stacked_grad_ms(params["layers"], cfg.n_layers)
    log(f"[train] 12a stacked-leaf gradient over {cfg.n_layers} layers: "
        f"{sel:.2f} ms indexing each layer, {unb:.2f} ms by one unbind "
        f"(the port's training forward): {sel - unb:.2f} ms a step saved, "
        f"beside a {step_s * 1e3:.1f} ms step")
    ok = bool(np.isfinite(losses).all() and np.mean(losses[-5:]) < losses[0])
    return {"12a: losses finite and falling": ok}, dict(
        step_ms=step_s * 1e3, tokens_s=tokens / step_s, peak_gib=peak,
        busy=busy, launches_per_step=n_launch / 2,
        mfu=exec_f / (step_s * peak_flops))


def train_7b_cut(device):
    """12b: the 7B's widths at ``TRAIN_7B_LAYERS`` layers, two
    micro-batches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import leaves

    full = get_config("synera-llm-7b")
    cfg = full.replace(n_layers=TRAIN_7B_LAYERS)
    _free(device)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, 0, device=device)
    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    n_params = sum(v.numel() for v in leaves(params))
    moments = sum(v.numel() * v.element_size()
                  for t in (state.mu, state.nu) for v in leaves(t))
    step = S.make_train_step(cfg, opt, micro_batches=2)
    rng = np.random.default_rng(5)
    times, mets = [], []
    for _ in range(TRAIN_7B_STEPS):
        toks = torch.as_tensor(rng.integers(
            0, cfg.vocab, (TRAIN_7B_BATCH, TRAIN_7B_SEQ)), device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = step(params, state, {"tokens": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = float(np.median(times[1:]))
    model_f, exec_f = train_flops(cfg, TRAIN_7B_BATCH, TRAIN_7B_SEQ)
    log(f"[train] 12b {full.name} at {cfg.n_layers} of {full.n_layers} "
        f"layers (widths as published: d {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}, remat {cfg.remat}): "
        f"{n_params / 1e9:.3f}B params, f32 moments "
        f"{moments / 2**30:.2f} GiB; micro-batches 2 of "
        f"{TRAIN_7B_BATCH // 2} x {TRAIN_7B_SEQ}")
    log(f"[train] 12b steps: " + "; ".join(
        f"loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f} "
        f"{t * 1e3:.1f} ms" for m, t in zip(mets, times)))
    log(f"[train] 12b step ms (median of steps 2-{TRAIN_7B_STEPS}): "
        f"{step_s * 1e3:.2f}; tokens/s "
        f"{TRAIN_7B_BATCH * TRAIN_7B_SEQ / step_s:.0f}; peak {peak:.2f} GiB; "
        f"mfu {exec_f / (step_s * PEAK_FLOPS['torch.bfloat16']):.4f} (with "
        f"the recompute, counted as in 12a)")
    ok = all(bool(np.isfinite(m["loss"])) and m["grad_norm"] > 0
             for m in mets)
    del params, state
    return {"12b: finite loss, grad_norm > 0": ok}, dict(
        step_ms=step_s * 1e3, peak_gib=peak)


def parity_case(name, impl, seed=0):
    """A reduced config (the tiny SLM by its name), its parameters from a
    seed on the host (a vlm's gates set to ``CROSS_GATE``) and a batch
    with its aux input from a numpy seed, all float32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.synera_pair import tiny_pair
    from repro_torch.models import model as M
    cfg = (tiny_pair(vocab=TINY_VOCAB)[0] if name == "tiny-slm"
           else get_config(name).reduced()).replace(attn_impl=impl)
    params = cross_params(cfg, seed, "cpu")
    rng = np.random.default_rng(seed + 17)
    B, T = TRAIN_PARITY_BATCH
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)))}
    if cfg.family in M.AUX_INPUTS:
        src = ((cfg.n_image_tokens, cfg.vision_dim) if cfg.family == "vlm"
               else (cfg.n_audio_frames, cfg.d_model))
        batch[M.AUX_INPUTS[cfg.family]] = torch.as_tensor(
            rng.standard_normal((B, *src)).astype(np.float32))
    return cfg, params, batch


def train_parity(device):
    """12c: one ``make_train_step`` (and the loss and gradients alone) on
    the card and on the host, from the same float32 parameters and batch,
    for one reduced config per family."""
    import torch
    from repro_torch.models import steps as S
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import flatten, tree_map

    checks = {}
    for name, impl in TRAIN_PARITY:
        cfg, host_p, host_b = parity_case(name, impl)
        dev_p = tree_map(lambda t: t.to(device), host_p)
        dev_b = {k: v.to(device) for k, v in host_b.items()}
        (hl, _), hg = S.loss_and_grad(cfg, host_p, host_b)
        (dl, _), dg = S.loss_and_grad(cfg, dev_p, dev_b)
        loss_err = abs(float(dl) - float(hl)) / abs(float(hl))
        grad_err = 0.0
        hgf = dict(flatten(hg))
        for p, g in flatten(dg):
            scale = float(hgf[p].abs().max())
            err = float((g.cpu() - hgf[p]).abs().max())
            grad_err = max(grad_err, err / scale if scale else err)
        news = []
        for params, batch in ((host_p, host_b), (dev_p, dev_b)):
            opt = AdamW(lr=TRAIN_PARITY_LR, weight_decay=0.01)
            new, _, met = S.make_train_step(cfg, opt)(
                params, opt.init(params), batch)
            news.append(dict(flatten(new)))
        lr = float(met["lr"])
        host_flat = dict(flatten(host_p))
        resolved_err, bound_ok, off, n_total = 0.0, True, 0, 0
        for p, g in hgf.items():
            err = (news[1][p].cpu() - news[0][p]).abs()
            resolved = g.abs() > TRAIN_GRAD_REL * float(g.abs().max())
            if bool(resolved.any()):
                resolved_err = max(resolved_err, float(err[resolved].max()))
            # below the resolved gradients Adam's first step is about
            # sign(g): either sign is right, within 2 lr of each other
            bound = 2 * lr * (1 + 0.01 * host_flat[p].abs()) \
                + TRAIN_PARAM_ATOL
            bound_ok &= bool((err <= bound).all())
            off += int((err > TRAIN_PARAM_ATOL).sum())
            n_total += err.numel()
        log(f"[train] 12c {cfg.name} ({cfg.family}, {impl}): loss "
            f"{float(hl):.6f} host / {float(dl):.6f} card, rel {loss_err:.2e};"
            f" grad max err {grad_err:.2e} of each leaf's max; params after "
            f"one step: {resolved_err:.2e} where the gradient is resolved, "
            f"{off} of {n_total} entries past {TRAIN_PARAM_ATOL:g} (each "
            f"within 2 lr)")
        checks[f"12c {cfg.name}: card = host"] = (
            loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_REL
            and resolved_err <= TRAIN_PARAM_ATOL and bound_ok
            and off <= 1e-3 * n_total)
    return checks


def train_tiny_pair(device):
    """12d: the tiny pair trained on the card with the reference
    prepare's settings, saved with the port's ``checkpoint.io.save`` and
    served from there by ``repro_torch.launch.serve`` in-process; the
    trained LLM must fit held-out text better than the SLM."""
    import tempfile
    import torch
    from repro_torch.configs.synera_pair import tiny_pair
    from repro_torch.data.synthetic import SyntheticTask, TaskSpec
    from repro_torch.launch import serve
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M

    task = SyntheticTask(TaskSpec(vocab=TINY_VOCAB))
    corpus, _ = task.corpus(n_sequences=64, length=2048, seed=0)
    held, _ = task.corpus(n_sequences=8, length=512, seed=1)
    held = {"tokens": torch.as_tensor(held, device=device)}
    nll = {}
    with tempfile.TemporaryDirectory() as d:
        for cfg in tiny_pair(vocab=TINY_VOCAB):
            steps = TINY_STEPS[cfg.name]
            t0 = time.perf_counter()
            params, losses = TR.train(cfg, steps=steps, corpus=corpus,
                                      log_every=100, device=device,
                                      ckpt_path=f"{d}/{cfg.name}.npz")
            wall = time.perf_counter() - t0
            with torch.no_grad():
                nll[cfg.name] = float(M.lm_loss(cfg, params, held)[1]["nll"])
            log(f"[train] 12d {cfg.name}: {steps} steps in {wall:.1f} s "
                f"({wall / steps * 1e3:.1f} ms a step), loss {losses[0]:.4f}"
                f" -> {np.mean(losses[-10:]):.4f}; held-out nll "
                f"{nll[cfg.name]:.4f}")
        t0 = time.perf_counter()
        summary = serve.main(["--ckpt", d, "--mode", "synera", "--requests",
                              "2", "--device", device, "--json"])
        serve_s = time.perf_counter() - t0
    empty = hashlib.sha256(json.dumps([[]] * 2).encode()).hexdigest()[:16]
    log(f"[train] 12d served from the port's checkpoints in {serve_s:.1f} s "
        f"(summary above)")
    return {"12d: served, non-empty streams": (
                summary["completed_streams"] == 2
                and summary["outputs_sha"] != empty),
            "12d: trained LLM's held-out nll below the SLM's":
                nll["tiny-llm"] < nll["tiny-slm"]}


def phase_train(device="cuda"):
    """Phase 12: training through the port.  12a trains the paper's 160M
    SLM whole (``launch.train.train``, 40 steps of 16 x 512, bf16, remat)
    and profiles two more steps; 12b takes 5 steps of the 7B's widths at
    4 layers with two micro-batches; 12c holds one train step of each
    family's reduced config on the card against the host in float32;
    12d trains the tiny pair, saves it with the port's
    ``checkpoint.io.save`` and serves it from there with
    ``launch.serve``; 12e: no attention or SSD kernel launches during
    12a-d (they have no gradient; the attention families train on the
    blocked path, mamba2 under "pallas" on the plain scan), the MoE steps
    of 12c run ``grouped_mm`` and ``grouped_mm_wgrad`` (the experts'
    products and their gradients on the card), and a train step under
    ``attn_impl="pallas"`` on an attention family raises."""
    from repro_torch.models import steps as S
    from repro_torch.tree import tree_map

    reset_launches()
    checks, numbers = {}, {}
    for sub, fn in (("12a", train_160m), ("12b", train_7b_cut)):
        c, numbers[sub] = fn(device)
        checks.update(c)
        _free(device)
    checks.update(train_parity(device))
    checks.update(train_tiny_pair(device))
    launched = read_launches()
    checks["12e: no attention or SSD kernel launched while training"] = \
        not any(v for k, v in launched.items() if k not in GROUPED)
    checks["12e: 12c's MoE steps ran grouped_mm and grouped_mm_wgrad"] = \
        all(launched[k] > 0 for k in GROUPED)
    cfg, params, batch = parity_case("tiny-slm", "pallas")
    params = tree_map(lambda t: t.to(device), params)
    batch = {k: v.to(device) for k, v in batch.items()}
    reset_launches()
    try:
        S.loss_and_grad(cfg, params, batch)
        refused = False
    except RuntimeError as e:
        refused = "no gradient" in str(e)
    checks["12e: a pallas train step raises on the card"] = (
        refused and not any(read_launches().values()))
    log(f"[train] 12e launches during 12a-d: {json.dumps(launched)}")
    log("[train] numbers: " + json.dumps(numbers))
    failed = [k for k, v in checks.items() if not v]
    log("[train] checks: " + json.dumps(checks))
    if failed:
        raise RuntimeError(f"training phase failed: {failed}")
    return numbers


# ---------------------------------------------------------------------------
# Phase 13: the mesh tooling

MESH_MOE_ARCH = "qwen3-moe-235b-a22b"
MESH_MOE_TOKENS = ((4, 1), (4, 256))     # (B, T): decode, prefill
MESH_MOE_TOL = 1e-4                      # f32, card vs host
MESH_BF16_COSINE = 0.99                  # bf16 vs f32 on the card
MESH_DECODE = ("llama3.2-1b", 8, 4096)   # whole; B, S


def moe_layer_params(cfg, seed, device):
    """One MoE layer at ``cfg``'s widths, in float32, at ``init_moe``'s
    scales, drawn from ``seed``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    d, E, dff = cfg.d_model, cfg.n_experts, cfg.d_ff

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device).mul_(scale)
    return {"router": normal(d, E, scale=d ** -0.5),
            "w_gate": normal(E, d, dff, scale=d ** -0.5),
            "w_up": normal(E, d, dff, scale=d ** -0.5),
            "w_down": normal(E, dff, d, scale=dff ** -0.5)}


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages under a tree's local tensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.dryrun import _tensors
    seen = {}
    for t in _tensors(tree):
        st = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def mesh_moe(mesh, host_mesh, device):
    """13i: ``moe_ffn_ep`` at the MoE config's published widths on the
    1 x 1 mesh, in float32 (held against the same call on the host) and
    bfloat16 (cosine against float32), its collectives counted."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import layers as L
    from repro_torch.models import shardctx
    from repro_torch.tree import tree_map

    cfg = get_config(MESH_MOE_ARCH)
    p32 = moe_layer_params(cfg, 0, device)
    p_host = tree_map(lambda t: t.cpu(), p32)
    pbf = dict(p32, **{k: p32[k].bfloat16() for k in ("w_gate", "w_up",
                                                     "w_down")})
    gen = torch.Generator(device=device).manual_seed(1)
    checks, numbers = {}, {}
    for B, T in MESH_MOE_TOKENS:
        x = torch.randn(B, T, cfg.d_model, generator=gen, device=device)
        with shardctx.hints(moe_mesh=(mesh, batch_axes(mesh))):
            with CommDebugMode() as comm:
                out, aux = L.moe_ffn_ep(p32, x, top_k=cfg.top_k)
            out_bf, _ = L.moe_ffn_ep(pbf, x.bfloat16(), top_k=cfg.top_k)
        with shardctx.hints(moe_mesh=(host_mesh, batch_axes(host_mesh))):
            ref, ref_aux = L.moe_ffn_ep(p_host, x.cpu(), top_k=cfg.top_k)
        counts = {str(k).split(".")[-1]: v
                  for k, v in comm.get_comm_counts().items()}
        err = (out.cpu() - ref).abs().max().item()
        aux_err = abs(aux.item() - ref_aux.item())
        cos = _cosine(out_bf, out)
        tag = f"13i {B}x{T}"
        numbers[tag] = {"max_abs_err": err, "aux_err": aux_err,
                        "bf16_cosine": cos, "collectives": counts}
        checks[f"{tag}: f32 card vs host within {MESH_MOE_TOL}"] = (
            err <= MESH_MOE_TOL and aux_err <= MESH_MOE_TOL)
        checks[f"{tag}: bf16 finite, cosine >= {MESH_BF16_COSINE}"] = bool(
            torch.isfinite(out_bf).all()) and cos >= MESH_BF16_COSINE
        checks[f"{tag}: 3 all-gathers and 3 all-reduces through the group"] = (
            counts.get("all_gather_into_tensor") == 3
            and counts.get("all_reduce") == 3)
    return checks, numbers


def mesh_decode_step(mesh, device):
    """13ii: llama3.2-1b's decode step (whole, B 8 over a 4,096-slot
    cache) from ``dryrun.build_step`` on the 1 x 1 mesh with real random
    weights: the counted argument bytes are the bytes the card holds for
    them, the counted peak of the step's own allocations lies within the
    card's, and neither roofline term may exceed the step's device time,
    the sum of its kernels' durations under ``torch.profiler`` (a bound
    above the time it bounds means the counter overcounts); the ratios
    say how tight each bound is."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as D
    from repro_torch.models import shardctx

    arch, B, S = MESH_DECODE
    cfg = get_config(arch)
    shape = InputShape(f"decode_{S}", S, B, "decode")
    _free(device)
    base = torch.cuda.memory_allocated()
    try:
        fn, args, pl = D.build_step(cfg, shape, mesh, device=device, seed=0)
        args = D.shard_args(args, pl, mesh)
        _free(device)
        held = torch.cuda.memory_allocated() - base
        stored = _storage_bytes(args)
        n_tensors = len(D._tensors(args))
        with implicit_replication():
            for _ in range(2):
                fn(*args)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() - before
            prof = profile_device_share(lambda: fn(*args))
        _, cost, memory, counted_s = D.measure(fn, args,
                                               sync=torch.cuda.synchronize)
    finally:
        shardctx.clear_hints()
    step_s = float(np.median(times))
    device_s = prof[1] if prof else float("nan")
    roof = D.roofline(cfg, shape, cost, mesh.size())
    numbers = {"step_s": step_s, "device_s": device_s,
               "t_memory_over_device": roof["t_memory"] / device_s,
               "t_compute_over_device": roof["t_compute"] / device_s,
               "top_kernels": [(k[:60], t, c) for k, t, c in prof[2][:5]]
               if prof else None,
               "counted_step_s": counted_s,
               "argument_bytes": memory["argument_bytes"],
               "card_storage_bytes": stored, "allocator_bytes": held,
               "flops": cost["flops"], "bytes": cost["bytes"],
               "collective_bytes": cost["collective_bytes"],
               "temp_bytes": memory["temp_bytes"], "card_peak_bytes": peak,
               "roofline": roof}
    checks = {
        "13ii: argument_bytes == the card's storage bytes of the arguments":
            memory["argument_bytes"] == stored,
        # the caching allocator rounds each allocation up to its block:
        # 512 B steps for small ones; a large one keeps its segment's
        # unsplit remainder (under 1 MiB)
        "13ii: the allocator holds them, each rounded up to its block":
            0 <= held - stored < n_tensors * (1 << 20),
        "13ii: temp_bytes <= the card's peak above the arguments":
            0 < memory["temp_bytes"] <= peak,
        "13ii: the profiler saw the step's kernels": prof is not None,
        "13ii: t_compute <= the step's device time":
            roof["t_compute"] <= device_s,
        "13ii: t_memory <= the step's device time":
            roof["t_memory"] <= device_s,
    }
    return checks, numbers


def phase_mesh(device="cuda"):
    """Phase 13: the mesh tooling on the card.  A process group of one
    rank over a ``HashStore`` (NCCL for CUDA tensors, gloo for the host
    reference) carries a 1 x 1 ``DeviceMesh("cuda")``: 13i runs
    ``moe_ffn_ep`` at qwen3-moe-235b-a22b's published widths (one layer;
    4 x 1 decode and 4 x 256 prefill tokens, the prefill past its
    experts' capacity), 13ii counts and times llama3.2-1b's decode step
    from ``dryrun.build_step`` with real weights; then, the group torn
    down, 13iii writes one production-mesh record (256 fake ranks,
    ``meta``) for llama3.2-1b ``decode_32k``.  None of the port's kernels
    may launch (the dry run decodes with the naive attention, and
    ``moe_ffn_ep`` has no kernel)."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh

    reset_launches()
    checks = {}
    dist.init_process_group("cpu:gloo,cuda:nccl" if device == "cuda"
                            else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(device_type=device)
        host_mesh = make_host_mesh(device_type="cpu")
        checks["13: the card's mesh runs on NCCL"] = (
            "nccl" in dist.get_backend(mesh.get_group("model")))
        c, numbers = mesh_moe(mesh, host_mesh, device)
        checks.update(c)
        _free(device)
        c, numbers["13ii"] = mesh_decode_step(mesh, device)
        checks.update(c)
        _free(device)
    finally:
        dist.destroy_process_group()
    rec = D.run_one(MESH_DECODE[0], "decode_32k",
                    out_dir=str(ROOT / "results" / "dryrun_torch"))
    numbers["13iii"] = {k: rec.get(k) for k in (
        "ok", "trace_s", "flops_per_dev", "bytes_per_dev",
        "collective_bytes_per_dev", "collective_by_kind", "memory",
        "roofline", "error")}
    checks["13iii: the 16 x 16 record of llama3.2-1b decode_32k"] = (
        rec["ok"] and rec["flops_per_dev"] > 0)
    launched = read_launches()
    checks["13: no kernel launched"] = not any(launched.values())
    log("[mesh] numbers: " + json.dumps(numbers))
    log("[mesh] checks: " + json.dumps(checks))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"mesh phase failed: {failed}")
    return numbers


# ---------------------------------------------------------------------------

PHASE_LIMIT_S = 450              # a phase that runs longer is hung


def _phase_timeout(signum, frame):
    raise TimeoutError(f"phase still running after {PHASE_LIMIT_S} s")


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

    main_recs, launches, state = {}, {}, {}
    t_start = time.perf_counter()
    signal.signal(signal.SIGALRM, _phase_timeout)

    def ssm():
        state.clear()           # frees the 160M/7B pair's weights
        gc.collect()            # and the engines' reference cycles
        torch.cuda.empty_cache()
        log(f"[ssm] {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
            f"allocated before phase 6")
        return phase_ssm()

    def hybrid():
        from repro_torch.configs import get_config
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config("zamba2-2.7b").replace(attn_impl="pallas")
        return phase_ssm(cfg, tiny=cfg.replace(n_layers=2 * cfg.attn_every),
                         plain_gate=HYBRID_PLAIN_GATE)

    try:
        for p, fn in ((1, phase_build), (2, phase_kernels),
                      (3, lambda: phase_full_width(state)),
                      (4, phase_tiny_identity),
                      (5, lambda: phase_paged_full_width(state)),
                      (7, lambda: phase_fleet(state)),
                      (6, ssm), (8, phase_dense_configs), (9, hybrid),
                      (10, phase_moe_configs), (11, phase_cross_configs),
                      (12, phase_train), (13, phase_mesh)):
            t0 = time.perf_counter()
            signal.alarm(PHASE_LIMIT_S)
            out = fn()
            signal.alarm(0)
            if p == 2:
                main_recs = out
            # each kernel's launches come from the path that runs it
            path = {3: DENSE_PATH, 5: PAGED_PATH, 6: SSM_PATH,
                    10: MOE_PATH}.get(p, ())
            launches.update({k: out[k] for k in path})
            log(f"[phase {p}] ok in {time.perf_counter() - t0:.1f} s")
    except Exception as e:  # report which phase failed, then exit non-zero
        signal.alarm(0)
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
