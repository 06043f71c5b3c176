"""Run the port's CUDA kernels on the CPU, for logic checks without a card.

    PYTHONPATH=src python tools/cuda_emu/emulate.py [attn_importance] [ssd_scan] [partial_prefill] [decode_gqa] [paged] [grouped_mm]

Each kernel source under ``src/repro_torch/kernels/csrc`` is rewritten for
the stub headers beside this file (the kernels' inline-PTX helpers become
emulated ones, ``kernel<<<...>>>(`` launches become ``emu::launch`` calls,
dynamic shared memory a per-block buffer), compiled with ``g++`` into
``build/cuda_emu/``, and called through ``ctypes`` on CPU tensors at small
shapes.  Its outputs are held against
the kernel's plain PyTorch version at ``chip_smoke.py``'s tolerances, and a
second call must give the same bits.  Every CUDA thread is a
``std::thread``, so the shapes stay small; nothing here is a timing.
``partial_prefill`` and ``decode_gqa`` at hd 64 / 128 with g <= 8 run
kernels already proven on the card, as a check of the emulation itself;
their hd 80 and g = 6 / 16 cases, and ``attn_importance``'s hd 80 cases,
check the shapes zamba2 and the dense configs add; their g = 5 (nh 40 /
nkv 8, llama4-maverick) and g = 16 at nkv 4 (qwen3-moe) cases, dense and
through the paged instances (``partial_prefill_paged``, ``decode_gqa_paged``),
the shapes the MoE configs add: at C = 8 the 40 packed rows of a g = 5
group leave the last 16-row tile half empty; and their g = 1 cases over
16 heads of 64 (whisper-medium's MHA decoder), the shapes the audio
family adds: at C = 8 one group's 8 rows fill half a 16-row tile.
``grouped_mm`` (the MoE layer's grouped product, its transposed-weight
input gradient and its weight gradient) runs at small widths with empty
groups, a group longer than one 128-row tile (forward) or than six
32-row stages (weight gradient), stages cut inside a group, unused tail
rows, K and N that are not whole tiles, and (bf16) K splits and a
persistent grid whose CTAs walk several units; its bf16 kernels' TMA,
mbarrier and wgmma helpers run through the stand-ins in ``cuda.h``, and
the units each CTA takes (the source's ``GROUPED_MM_TRACE_UNIT`` hook)
must be ``kernels/grouped_mm.py:tile_walk``'s; each group is held to
the tolerance on its own scale.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import DTYPE_CODES
from repro_torch.kernels import attn_importance as AI
from repro_torch.kernels import build
from repro_torch.kernels import decode_gqa as DG
from repro_torch.kernels import grouped_mm as GM
from repro_torch.kernels import paged as PG
from repro_torch.kernels import partial_prefill as PP
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models.layers import softplus

HERE = Path(__file__).resolve().parent
OUT = HERE.parents[1] / "build" / "cuda_emu"
TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}

# emulated bodies of the kernels' inline-PTX helpers (attn_common.cuh's
# cp.async helpers, partial_prefill.cu's ldmatrix and mma)
BODIES = {
    "smem_addr": "{ return (unsigned)((const unsigned char*)p"
                 " - emu::smem()); }",
    "cp_async16": "{ if (fill) std::memcpy(dst, src, 16);"
                  " else std::memset(dst, 0, 16); }",
    "cp_async4": "{ std::memcpy(dst, src, 4); }",
    "cp_async_commit": "{}",
    "cp_async_wait": "{}",
    "ldsm_x4": "{ emu::ldsm(p, r0, r1, r2, r3, false); }",
    "ldsm_x4_trans": "{ emu::ldsm(p, r0, r1, r2, r3, true); }",
    "mma_bf16": "{ emu::mma(c, a, b0, b1); }",
    # grouped_mm.cu's TMA / mbarrier / wgmma helpers (cuda.h, cuda_runtime.h)
    "mbar_init": "{ emu::mbar_init(bar, (int)count); }",
    "fence_barrier_init": "{}",
    "mbar_expect_tx": "{ emu::mbar_arrive(bar, bytes); }",
    "mbar_arrive": "{ emu::mbar_arrive(bar, 0); }",
    "mbar_try_wait": "{ return emu::mbar_try_wait(bar, parity); }",
    "prefetch_tmap": "{}",
    "tma_load_2d": "{ const int c[3] = {c0, c1, 0};"
                   " emu::tma_load(dst, map, bar, c); }",
    "tma_load_3d": "{ const int c[3] = {c0, c1, c2};"
                   " emu::tma_load(dst, map, bar, c); }",
    "tma_store_3d": "{ const int c[3] = {c0, c1, c2};"
                    " emu::tma_store(map, src, c); }",
    "bulk_commit": "{}",
    "bulk_wait_read": "{}",
    "bulk_wait_all": "{}",
    "fence_proxy_async": "{}",
    "named_bar_sync": "{ emu::named_bar(id, count); }",
    "wgmma_fence": "{}",
    "wgmma_commit": "{}",
    # wgmma is warpgroup-collective: the wait returns once all four warps
    # have issued, so after it every thread of the group has passed its
    # stage's full-barrier wait (a private barrier id, past the 16 real)
    "wgmma_wait0": "{ emu::named_bar(16 + threadIdx.x / 128, 128); }",
    "fence_acc": "{}",
    "wgmma": "{ emu::wgmma(d, N, da, db, TA, TB); }",
}


# grouped_mm.cu's walk hook: every unit a CTA takes (its CTA, then the
# unit's index and tile_walk()'s fields), read back through emu_walk()
WALK_HOOK = r"""#include <mutex>
#include <vector>
namespace emu_walk_log {
inline std::mutex mu;
inline std::vector<int> rows;
}
#define GROUPED_MM_TRACE_UNIT(...)                                 \
  do {                                                             \
    const int f_[] = {(int)blockIdx.x, __VA_ARGS__};               \
    const std::lock_guard<std::mutex> l_(emu_walk_log::mu);        \
    emu_walk_log::rows.insert(emu_walk_log::rows.end(), f_, f_ + 11); \
  } while (0)
extern "C" int emu_walk(int* out, int cap) {  // ints copied; then cleared
  const std::lock_guard<std::mutex> l(emu_walk_log::mu);
  const int n = (int)emu_walk_log::rows.size();
  for (int i = 0; i < n && i < cap; ++i) out[i] = emu_walk_log::rows[i];
  emu_walk_log::rows.clear();
  return n;
}
"""
WALK_FIELDS = 11


def _replace_body(src: str, name: str) -> str:
    """``src`` with helper ``name``'s body replaced, where it is defined."""
    m = re.search(r"(__device__ __forceinline__ \w+ " + name
                  + r"\(.*?\)\s*)\{", src, re.S)
    if m is None:
        return src
    depth = 0
    for end in range(m.end() - 1, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            break
    return src[:m.start()] + m.group(1) + BODIES[name] + src[end + 1:]


def load(name: str) -> ctypes.CDLL:
    """Translate, compile and load kernel library ``name`` for the CPU."""
    srcdir = OUT / "src"
    srcdir.mkdir(parents=True, exist_ok=True)
    for f in (build.CSRC / "attn_common.cuh", build.CSRC / f"{name}.cu"):
        text = f.read_text()
        for helper in BODIES:
            text = _replace_body(text, helper)
        text = re.sub(
            r"extern __shared__ __align__\(\d+\) unsigned char smem_raw\[\];",
            "unsigned char* smem_raw = emu::smem();", text)
        text = re.sub(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                      r"emu::launch(\1, \2, ", text, flags=re.S)
        if f.name == "grouped_mm.cu":
            text = WALK_HOOK + text
        (srcdir / f.name).write_text(text)
    lib = OUT / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-x", "c++", f"-I{HERE}", f"-I{srcdir}", "-o", str(lib),
                    str(srcdir / f"{name}.cu"), "-lpthread"], check=True)
    dll = ctypes.CDLL(str(lib))
    for fname, argtypes in build.SIGNATURES[name].items():
        getattr(dll, fname).argtypes = argtypes
        getattr(dll, fname).restype = ctypes.c_int
    return dll


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__} returned error {err}")


def _report(label, errs, ok):
    print(f"{label}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + ("  ok" if ok else "  FAIL"), flush=True)
    return ok


def check_attn_importance() -> bool:
    fn = load("attn_importance").attn_importance_launch
    ok = True
    # (B, Tq, S, nh, nkv, hd, fill lo, fill hi, causal, idle slot 1)
    cases = [(1, 1, 512, 2, 2, 64, 64, 288, True, False),
             (2, 8, 256, 4, 2, 64, 32, 200, True, False),
             (2, 1, 1000, 2, 2, 64, 100, 990, True, True),
             (1, 16, 128, 8, 1, 128, 30, 100, True, False),
             (1, 1, 4096, 2, 2, 32, 2000, 4000, True, False),
             (2, 3, 512, 2, 2, 16, 0, 20, True, False),
             (1, 20, 96, 2, 1, 32, 10, 60, False, False),
             (1, 1, 512, 2, 2, 80, 64, 288, True, False),
             (2, 5, 200, 2, 2, 80, 20, 150, True, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, Tq, S, nh, nkv, hd, lo, hi, causal, idle in cases:
            rng = np.random.default_rng(0)
            qp = np.full((B, Tq), -1, np.int32)
            kp = np.full((B, S), -1, np.int32)
            for b in range(B):
                n = int(rng.integers(lo, hi))
                kp[b, :n + Tq] = np.arange(n + Tq)
                qp[b] = n + np.arange(Tq)
            if idle:
                qp[1] = -1
            g = torch.Generator().manual_seed(0)
            q, k, v = (torch.randn(*s, generator=g).to(dtype) for s in (
                (B, Tq, nh, hd), (B, S, nkv, hd), (B, S, nkv, hd)))
            qpt, kpt = torch.from_numpy(qp), torch.from_numpy(kp)
            runs = []
            for _ in range(2):
                out = torch.full_like(q, float("nan"))
                imp = torch.full((B, nh, S), float("nan"))
                _call(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          qpt.data_ptr(), kpt.data_ptr(), out.data_ptr(),
                          imp.data_ptr(), B, Tq, S, nh, nkv, hd, int(causal),
                          DTYPE_CODES[dtype], None)
                runs.append((out, imp))
            (out, imp), (out2, imp2) = runs
            o_ref, i_ref = AI.attn_with_importance_ref(q, k, v, qpt, kpt,
                                                       causal=causal)
            tol = TOL[dtype]
            e_o = float((out.float() - o_ref.float()).abs().max())
            e_i = float((imp - i_ref).abs().max())
            good = (e_o <= tol + tol * float(o_ref.float().abs().max())
                    and e_i <= 1e-3 and bool((imp[i_ref == 0] == 0).all())
                    and torch.equal(out, out2) and torch.equal(imp, imp2))
            ok &= _report(f"attn_importance {B, Tq, S, nh, nkv, hd} "
                          f"causal={causal} idle={idle} {dtype}",
                          {"out": e_o, "imp": e_i}, good)
    return ok


def check_ssd_scan() -> bool:
    fn = load("ssd_scan").ssd_scan_launch
    ok = True
    # (B, L, H, P, N, chunk, h0, dt shift: 4 makes the state carry far)
    cases = [(1, 64, 2, 16, 16, 32, True, 0.0), (2, 50, 2, 32, 16, 16, False, 0.0),
             (1, 70, 3, 8, 8, 32, True, 0.0), (1, 300, 1, 64, 128, 256, True, 0.0),
             (1, 96, 2, 64, 64, 48, False, 0.0), (1, 40, 2, 12, 20, 40, True, 0.0),
             (1, 512, 1, 64, 128, 256, True, 4.0)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, L, H, P, N, chunk, use_h0, shift in cases:
            g = torch.Generator().manual_seed(3)

            def r(*s):
                return torch.randn(*s, generator=g)

            x = (r(B, L, H, P) * 0.5).to(dtype)
            dt = softplus(r(B, L, H) - shift)
            A = -torch.exp(r(H) * 0.3)
            Bm, Cm = (r(B, L, N) * 0.5).to(dtype), (r(B, L, N) * 0.5).to(dtype)
            h0 = r(B, H, P, N) * 0.2 if use_h0 else None
            Q = min(chunk, L)
            nc, Qp = -(-L // Q), -(-Q // 16) * 16
            runs = []
            for _ in range(2):
                y = torch.full_like(x, float("nan"))
                h = torch.full((B, H, P, N), float("nan"))
                cb = torch.full((B, nc, Qp, Qp), float("nan"))
                dac = torch.full((2, B, nc, Qp, H), float("nan"))
                st = torch.full((B, nc, H, P, N), float("nan"))
                _call(fn, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                          Bm.data_ptr(), Cm.data_ptr(), _ptr(h0), y.data_ptr(),
                          h.data_ptr(), cb.data_ptr(), dac[0].data_ptr(),
                          dac[1].data_ptr(), st.data_ptr(), B, L, H, P, N, Q,
                          DTYPE_CODES[dtype], None)
                runs.append((y, h))
            (y, h), (y2, h2) = runs
            # the passes' plain versions scan dAc in f32 as the kernel does
            y_ref, h_ref = SS.ssd_scan_passes(x, dt, A, Bm, Cm, chunk=chunk,
                                              h0=h0)
            tol = TOL[dtype]
            e_y = float((y.float() - y_ref.float()).abs().max())
            e_h = float((h - h_ref).abs().max())
            good = (e_y <= tol + tol * float(y_ref.float().abs().max())
                    and e_h <= 10 * tol and bool(torch.isfinite(y.float()).all())
                    and torch.equal(y, y2) and torch.equal(h, h2))
            ok &= _report(f"ssd_scan {B, L, H, P, N} chunk={chunk} h0={use_h0}"
                          f" dt shift {shift} {dtype}", {"y": e_y, "h": e_h},
                          good)
    return ok


def _workspace(groups, splits, rows, hd):
    """The split-KV scratch of a dense launch (NaN-filled), as pointers."""
    if splits == 1:
        return None, None, None
    ws = PG.split_workspace(groups, splits, rows, hd, "cpu")
    for t in ws:
        t.fill_(float("nan"))
    return ws


def check_partial_prefill() -> bool:
    fn = load("partial_prefill").partial_prefill_launch
    # (B, C, S, nh, nkv, hd, splits): hd 64 is the card-proven case; hd 80
    # (zamba2) as one row tile, as 80 rows over two tiles with a split,
    # and as a full 64-row tile; g = 6 (qwen2-1.5b) and g = 16 (glm4-9b)
    # g = 5 (llama4-maverick) and g = 16 over nkv 4 (qwen3-moe) at C = 8
    # (40 rows: a half-empty last tile) and C = 64; g = 1 over 16 heads of
    # 64 (whisper-medium) at C = 8 (half a tile) and C = 64 with a split
    cases = [(2, 16, 128, 4, 2, 64, 1), (2, 16, 160, 4, 4, 80, 1),
             (1, 40, 200, 2, 2, 80, 2), (1, 64, 128, 4, 4, 80, 1),
             (1, 8, 128, 12, 2, 128, 1), (1, 4, 160, 32, 2, 128, 2),
             (2, 8, 128, 40, 8, 128, 1), (1, 8, 160, 40, 8, 128, 2),
             (1, 64, 96, 10, 2, 128, 1), (1, 8, 128, 64, 4, 128, 1),
             (1, 64, 96, 64, 4, 128, 2), (1, 8, 128, 16, 16, 64, 1),
             (1, 64, 128, 16, 16, 64, 2)]
    ok = True
    for B, C, S, nh, nkv, hd, splits in cases:
        rng = np.random.default_rng(0)
        qp = np.full((B, C), -1, np.int32)
        kp = np.full((B, S), -1, np.int32)
        for b in range(B):
            n = int(rng.integers(20, S - C))
            nq = int(rng.integers(1, C + 1))
            kp[b, :n + nq] = np.arange(n + nq)
            qp[b, :nq] = n + np.arange(nq)
        qpt, kpt = torch.from_numpy(qp), torch.from_numpy(kp)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(0)
            q, k, v = (torch.randn(*s, generator=g).to(dtype) for s in (
                (B, C, nh, hd), (B, S, nkv, hd), (B, S, nkv, hd)))
            ws = _workspace(B * nkv, splits, nh // nkv * C, hd)
            out = torch.full_like(q, float("nan"))
            _call(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  qpt.data_ptr(), kpt.data_ptr(), None, out.data_ptr(),
                  *(_ptr(t) for t in ws), B, C, S, nh, nkv, hd, splits, 0,
                  DTYPE_CODES[dtype], None)
            ref = PP.partial_prefill_ref(q, k, v, qpt, kpt)
            e = float((out.float() - ref.float()).abs().max())
            good = e <= TOL[dtype] and bool((out[qpt < 0] == 0).all())
            ok &= _report(f"partial_prefill {B, C, S, nh, nkv, hd} "
                          f"splits={splits} {dtype}", {"out": e}, good)
    return ok & check_partial_prefill_slots(fn)


def check_partial_prefill_slots(fn) -> bool:
    """The slot index: B query slots over a cache of more slots, query
    slot b on cache row ``slots[b]``, must give the same bits as the
    unindexed launch on the gathered rows (the rows no query reads hold
    keys too)."""
    ok = True
    # (B, C, S, nh, nkv, hd, cache slots, splits)
    for B, C, S, nh, nkv, hd, n_cache, splits in (
            (2, 16, 128, 4, 4, 128, 5, 1), (1, 16, 160, 8, 2, 64, 4, 2),
            (2, 8, 128, 64, 4, 128, 3, 2)):
        rng = np.random.default_rng(1)
        kp = np.full((n_cache, S), -1, np.int32)
        qp = np.full((B, C), -1, np.int32)
        # descending: no query slot reads its own row
        slots = np.sort(rng.choice(n_cache, B, replace=False))[::-1].astype(
            np.int32)
        for b in range(n_cache):
            n = int(rng.integers(C, S))
            kp[b, :n] = np.arange(n)
        for i, b in enumerate(slots):
            n = int(rng.integers(20, S - C))
            nq = int(rng.integers(1, C + 1))
            kp[b] = -1
            kp[b, :n + nq] = np.arange(n + nq)
            qp[i, :nq] = n + np.arange(nq)
        qpt, kpt = torch.from_numpy(qp), torch.from_numpy(kp)
        st = torch.from_numpy(slots)
        gk = st.long()
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(1)
            q, k, v = (torch.randn(*s, generator=g).to(dtype) for s in (
                (B, C, nh, hd), (n_cache, S, nkv, hd), (n_cache, S, nkv, hd)))
            outs = []
            for kk, vv, pp, sp in ((k, v, kpt, st.data_ptr()),
                                   (k[gk].contiguous(), v[gk].contiguous(),
                                    kpt[gk].contiguous(), None)):
                ws = _workspace(B * nkv, splits, nh // nkv * C, hd)
                out = torch.full_like(q, float("nan"))
                _call(fn, q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                      qpt.data_ptr(), pp.data_ptr(), sp, out.data_ptr(),
                      *(_ptr(t) for t in ws), B, C, S, nh, nkv, hd, splits,
                      0, DTYPE_CODES[dtype], None)
                outs.append(out)
            ref = PP.partial_prefill_ref(q, k, v, qpt, kpt, slots=st)
            e = float((outs[0].float() - ref.float()).abs().max())
            good = (e <= TOL[dtype] and torch.equal(outs[0], outs[1])
                    and bool((outs[0][qpt < 0] == 0).all()))
            ok &= _report(f"partial_prefill slots={slots.tolist()} of "
                          f"{n_cache} {B, C, S, nh, nkv, hd} splits={splits} "
                          f"{dtype}", {"out": e}, good)
    return ok


def check_decode_gqa() -> bool:
    fn = load("decode_gqa").decode_gqa_launch
    # (B, S, nh, nkv, hd, window, splits, idle slot 1): hd 128 g 4 is the
    # card-proven case; hd 80 (zamba2) one split, three splits and a
    # window; g = 6 (qwen2-1.5b) and g = 16 (glm4-9b); g = 5
    # (llama4-maverick, nh 40 / nkv 8) and g = 16 over nkv 4 (qwen3-moe);
    # g = 1 over 16 heads of 64 (whisper-medium), with an idle slot
    cases = [(2, 200, 8, 2, 128, 0, 2, False), (2, 200, 4, 4, 80, 0, 1, True),
             (2, 300, 4, 4, 80, 0, 3, False), (2, 256, 2, 2, 80, 64, 2, False),
             (1, 300, 12, 2, 128, 0, 2, False),
             (1, 300, 32, 2, 128, 0, 1, False),
             (2, 200, 40, 8, 128, 0, 2, True),
             (1, 300, 40, 8, 128, 0, 1, False),
             (1, 200, 64, 4, 128, 0, 3, False),
             (2, 200, 16, 16, 64, 0, 2, True),
             (1, 300, 16, 16, 64, 0, 1, False)]
    ok = True
    for B, S, nh, nkv, hd, window, splits, idle in cases:
        rng = np.random.default_rng(1)
        kp = np.full((B, S), -1, np.int32)
        qp = np.zeros(B, np.int32)
        for b in range(B):
            n = int(rng.integers(S // 2, S))
            kp[b, :n] = np.arange(n)
            qp[b] = n - 1
        if idle:
            qp[1] = -1
        qpt, kpt = torch.from_numpy(qp), torch.from_numpy(kp)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(1)
            q, k, v = (torch.randn(*s, generator=g).to(dtype) for s in (
                (B, nh, hd), (B, S, nkv, hd), (B, S, nkv, hd)))
            ws = _workspace(B * nkv, splits, nh // nkv, hd)
            out = torch.full_like(q, float("nan"))
            _call(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  qpt.data_ptr(), kpt.data_ptr(), out.data_ptr(),
                  *(_ptr(t) for t in ws), B, S, nh, nkv, hd, splits, window,
                  DTYPE_CODES[dtype], None)
            ref = DG.decode_attention_ref(q, k, v, qpt, kpt, window=window)
            e = float((out.float() - ref.float()).abs().max())
            good = e <= TOL[dtype] and (not idle or bool((out[1] == 0).all()))
            ok &= _report(f"decode_gqa {B, S, nh, nkv, hd} window={window} "
                          f"splits={splits} idle={idle} {dtype}", {"out": e},
                          good)
    return ok


def _paged_inputs(B, C, nkv, hd, bs, mbps, fill, seed):
    """A pool of 2 * B * mbps blocks of ``bs`` rows; each slot's table maps
    a ragged run of a random permutation of them (-1 tail) holding
    ``fill`` tokens, and its C queries sit at the tail (C = 1: decode)."""
    rng = np.random.default_rng(seed)
    nb = 2 * B * mbps
    pos = np.full((nb, bs), -1, np.int32)
    bt = np.full((B, mbps), -1, np.int32)
    qp = np.full((B, C), -1, np.int32)
    perm = iter(rng.permutation(nb))
    for b in range(B):
        n = int(rng.integers(fill // 2, fill))
        for j in range(-(-n // bs)):
            blk = next(perm)
            bt[b, j] = blk
            k = min(bs, n - j * bs)
            pos[blk, :k] = j * bs + np.arange(k)
        nq = C if C == 1 else int(rng.integers(1, C + 1))
        qp[b, :nq] = n - nq + np.arange(nq)
    return nb, torch.from_numpy(pos), torch.from_numpy(bt), \
        torch.from_numpy(qp)


def check_paged() -> bool:
    """The paged instances of both kernels at the MoE configs' groups:
    (B, C, nh, nkv, hd, block size, max_bps, fill, block_kv, kv_splits);
    C = 1 is decode."""
    fns = {"prefill": load("partial_prefill").partial_prefill_paged_launch,
           "decode": load("decode_gqa").decode_gqa_paged_launch}
    cases = [(2, 8, 40, 8, 128, 16, 8, 120, 32, 2),
             (1, 64, 10, 2, 128, 16, 8, 120, None, 1),
             (1, 8, 64, 4, 128, 16, 8, 120, 64, 1),
             (2, 1, 40, 8, 128, 16, 8, 120, 32, 3),
             (1, 1, 64, 4, 128, 16, 8, 120, None, 1)]
    ok = True
    for B, C, nh, nkv, hd, bs, mbps, fill, blkv, ksplits in cases:
        nb, pos, bt, qp = _paged_inputs(B, C, nkv, hd, bs, mbps, fill, 2)
        fuse, splits, spb = PG.fused_layout(mbps, bs, blkv, ksplits)
        kind = "decode" if C == 1 else "prefill"
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(2)
            q, kpool, vpool = (
                torch.randn(*s, generator=g).to(dtype)
                for s in ((B, C, nh, hd), (nb, bs, nkv, hd),
                          (nb, bs, nkv, hd)))
            ws = _workspace(B * nkv, splits, nh // nkv * C, hd)
            if kind == "decode":
                q, qpos = q[:, 0].contiguous(), qp[:, 0].contiguous()
                shape = (B, nh, nkv, hd, bs)
            else:
                qpos, shape = qp, (B, C, nh, nkv, hd, bs)
            out = torch.full_like(q, float("nan"))
            _call(fns[kind], q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                  qpos.data_ptr(), pos.data_ptr(), bt.data_ptr(),
                  out.data_ptr(), *(_ptr(t) for t in ws), *shape, mbps,
                  splits, spb * fuse, 0, DTYPE_CODES[dtype], None)
            if kind == "decode":
                ref = DG.decode_attention_paged_ref(
                    q, kpool, vpool, qpos, pos, bt, block_kv=blkv,
                    kv_splits=ksplits)
            else:
                ref = PP.partial_prefill_paged_ref(
                    q, kpool, vpool, qpos, pos, bt, block_kv=blkv,
                    kv_splits=ksplits)
            e = float((out.float() - ref.float()).abs().max())
            good = e <= TOL[dtype] and (kind == "decode"
                                        or bool((out[qpos < 0] == 0).all()))
            ok &= _report(f"{kind}_paged {B, C, nh, nkv, hd} block {bs} "
                          f"splits={splits} fuse={fuse} {dtype}", {"out": e},
                          good)
    return ok


def _ends(sizes):
    return torch.tensor(np.cumsum(sizes), dtype=torch.int32)


def _walk_is_spec(lib, ends, M, K, N, *, wgrad, splits, ctas) -> bool:
    """The units the last launch's CTAs took are tile_walk()'s, in its
    order: unit u, and only it, on CTA u % ctas."""
    cap = 1 << 20
    buf = (ctypes.c_int * cap)()
    n = lib.emu_walk(buf, cap)
    if n > cap:
        raise RuntimeError(f"emu_walk: {n} ints past the buffer's {cap}")
    got = sorted((tuple(buf[i:i + WALK_FIELDS])
                  for i in range(0, n, WALK_FIELDS)), key=lambda r: r[1])
    want = GM.tile_walk(ends, M, K, N, wgrad=wgrad, splits=splits)
    return ([r[1] for r in got] == list(range(len(want)))
            and all(r[0] == r[1] % ctas for r in got)
            and [r[2:] for r in got] == [tuple(w) for w in want])


def _group_err(out, ref, ends, wgrad, tol) -> tuple[float, bool]:
    """max |out - ref| and whether every group is within tol + tol
    max |ref| over its own rows (forward) or its own dw (weight
    gradient), so a fault the size of a small group's values shows."""
    b = [0] + [int(v) for v in ends]
    parts = ([(out[e], ref[e]) for e in range(len(b) - 1)] if wgrad else
             [(out[s:t], ref[s:t]) for s, t in zip(b, b[1:]) if t > s])
    good, worst = True, 0.0
    for o, r in parts:
        e = float((o.float() - r.float()).abs().max())
        worst = max(worst, e)
        good &= e <= tol + tol * float(r.float().abs().max())
    return worst, good


def check_grouped_mm() -> bool:
    """Forward, transposed forward (the input gradient) and weight
    gradient against their plain versions, group by group; a second call
    must give the same bits, and NaN-filled outputs must come back fully
    written.  bf16 runs the TMA kernels on a grid of 3 CTAs (each walks
    several units, and the rings wrap), with 1 and with 3 K splits, and
    the units each CTA takes must be tile_walk()'s."""
    lib = load("grouped_mm")
    lib.emu_walk.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.emu_walk.restype = ctypes.c_int
    fwd, wgrad = lib.grouped_mm_launch, lib.grouped_mm_wgrad_launch
    # (group sizes, tail rows past ends[-1], K, N): empty groups; one group
    # of 70 rows; K 40 and N 72 cut the last tile; one row in all (a
    # decode's group); a 210-row group (two 128-row tiles, 7 wgrad stages
    # of 32, the last cut at 18 rows) and 70 tail rows; K 256 (four
    # 64-wide stages, three splits of them) with groups of 13 and 45 rows
    cases = [((3, 0, 70, 5), 4, 64, 128), ((0, 16, 0, 1), 0, 40, 72),
             ((100, 2), 3, 72, 40), ((0, 0, 1), 2, 32, 64),
             ((2, 210, 0, 10), 70, 16, 64), ((13, 0, 45), 5, 256, 136)]
    ok = True
    for sizes, tail, K, N in cases:
        E, M = len(sizes), sum(sizes) + tail
        ends = _ends(sizes)
        for dtype in (torch.float32, torch.bfloat16):
            variants = [(1, 1)] if dtype == torch.float32 else [(1, 3), (3, 3)]
            g = torch.Generator().manual_seed(4)
            x = torch.randn(M, K, generator=g).to(dtype)
            w = (torch.randn(E, K, N, generator=g) / K ** 0.5).to(dtype)
            wt = w.transpose(1, 2).contiguous()         # (E, N, K)
            dy = torch.randn(M, N, generator=g).to(dtype)
            refs = (GM.grouped_mm_ref(x, w, ends),
                    GM.grouped_mm_ref(x, wt, ends, trans_w=True),
                    GM.grouped_mm_wgrad_ref(x, dy, ends))
            for splits, ctas in variants:
                part = (torch.full((splits, M, N), float("nan"))
                        if splits > 1 else None)
                bf16 = dtype == torch.bfloat16
                runs, walks = [], True
                for _ in range(2):
                    y = torch.full((M, N), float("nan"), dtype=dtype)
                    yt = torch.full((M, N), float("nan"), dtype=dtype)
                    dw = torch.full((E, K, N), float("nan"), dtype=dtype)
                    for out, wk, trans in ((y, w, 0), (yt, wt, 1)):
                        _call(fwd, x.data_ptr(), wk.data_ptr(),
                              ends.data_ptr(), out.data_ptr(), _ptr(part), M,
                              K, N, E, trans, DTYPE_CODES[dtype], splits,
                              ctas, None)
                        if bf16:
                            walks &= _walk_is_spec(lib, ends, M, K, N,
                                                   wgrad=False, splits=splits,
                                                   ctas=ctas)
                    _call(wgrad, x.data_ptr(), dy.data_ptr(), ends.data_ptr(),
                          dw.data_ptr(), M, K, N, E, DTYPE_CODES[dtype], ctas,
                          None)
                    if bf16:
                        walks &= _walk_is_spec(lib, ends, M, K, N, wgrad=True,
                                               splits=1, ctas=ctas)
                    runs.append((y, yt, dw))
                errs, good = {}, walks
                for label, out, out2, ref in zip(("y", "y (trans)", "dw"),
                                                 *runs, refs):
                    errs[label], close = _group_err(out, ref, ends,
                                                    label == "dw", TOL[dtype])
                    good &= close and torch.equal(out, out2)
                good &= bool((runs[0][0][M - tail:] == 0).all())
                good &= bool((runs[0][1][M - tail:] == 0).all())
                ok &= _report(f"grouped_mm sizes {sizes} tail {tail} K {K} "
                              f"N {N} {dtype} splits {splits} ctas {ctas}"
                              + (f", walk as tile_walk {walks}" if bf16
                                 else ""), errs, good)
    return ok


CHECKS = {"attn_importance": check_attn_importance,
          "ssd_scan": check_ssd_scan,
          "partial_prefill": check_partial_prefill,
          "decode_gqa": check_decode_gqa,
          "paged": check_paged,
          "grouped_mm": check_grouped_mm}

if __name__ == "__main__":
    torch.set_num_threads(1)
    names = sys.argv[1:] or list(CHECKS)
    results = [CHECKS[n]() for n in names]
    sys.exit(0 if all(results) else 1)
