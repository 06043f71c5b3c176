"""Mamba2 SSD chunked scan (state-space duality).

Port of ``repro/kernels/ssd_scan/ssd_scan.py`` (``ssd_scan``), its oracle
``ref.py`` (``ssd_scan_ref``) and its wrapper ``ops.py`` (``ssd``, which
adds the D skip term).  :func:`ssd_scan_ref` is the plain version: the
sequence padded to a multiple of ``Q = min(chunk, L)`` with dt = 0 (a
no-op on the state), then the model path's ``ssd_chunked``.  The CUDA
kernel (``csrc/ssd_scan.cu``) computes the same chunks in the same
order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import (DTYPE_CODES, build, on_cpu, raise_on_error,
                                 stream_ptr)

# kernel launches since the last reset (plain calls excluded)
launches = 0

# what the CUDA kernel takes (its shared-memory tiles are sized for these)
MAX_HEAD_DIM = 64      # P
MAX_STATE = 128        # N
MAX_CHUNK = 256        # Q


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int = 64, h0=None):
    """x: (B, L, H, P); dt: (B, L, H) f32, softplus'd; A: (H,) f32,
    negative; Bm, Cm: (B, L, N); h0: (B, H, P, N) f32 or None.

    Returns (y (B, L, H, P) in x's dtype, h_final (B, H, P, N) f32)."""
    # models.layers imports this module, so it is imported at call time
    from repro_torch.models.layers import ssd_chunked
    L = x.shape[1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y, h = ssd_chunked(x, dt, A, Bm, Cm, chunk=Q, h0=h0)
    return y[:, :L], h


def _check(x, dt, A, Bm, Cm, h0, chunk) -> int:
    """Validate a CUDA launch; returns the dtype code of x, Bm and Cm."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_scan: dtype {x.dtype} unsupported "
                        f"(float32 or bfloat16)")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, Bm, Cm dtypes differ: {x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}")
    f32 = [dt, A] + ([h0] if h0 is not None else [])
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("ssd_scan: dt, A and h0 must be float32")
    shapes = {"dt": (dt, (B, L, H)), "A": (A, (H,)), "Bm": (Bm, (B, L, N)),
              "Cm": (Cm, (B, L, N))}
    if h0 is not None:
        shapes["h0"] = (h0, (B, H, P, N))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_scan: {name} {tuple(t.shape)}, "
                             f"expected {want}")
    if not all(t.is_contiguous() for t in [x] + f32 + [Bm, Cm]):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if not (0 < P <= MAX_HEAD_DIM and 0 < N <= MAX_STATE
            and 0 < min(chunk, L) <= MAX_CHUNK):
        raise ValueError(
            f"ssd_scan: P {P}, N {N}, chunk {min(chunk, L)} unsupported "
            f"(at most {MAX_HEAD_DIM}, {MAX_STATE}, {MAX_CHUNK})")
    return DTYPE_CODES[x.dtype]


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 64, h0=None):
    """Same contract as :func:`ssd_scan_ref`; launches the CUDA kernel for
    CUDA tensors (rows past L are read as dt = 0, never padded)."""
    global launches
    args = (x, dt, A, Bm, Cm) + ((h0,) if h0 is not None else ())
    if on_cpu(*args):
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    code = _check(x, dt, A, Bm, Cm, h0, chunk)
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    fn = build.library("ssd_scan").ssd_scan_launch
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), h0.data_ptr() if h0 is not None else None,
             y.data_ptr(), h_out.data_ptr(), B, L, H, P, N, min(chunk, L),
             code, stream_ptr(x))
    raise_on_error("ssd_scan", err)
    launches += 1
    return y, h_out


def ssd(x, dt, A, Bm, Cm, D=None, *, chunk: int = 64, h0=None):
    """:func:`ssd_scan` plus the D skip term ``D[h] * x`` the model path
    applies (the reference's ``ops.ssd``)."""
    y, h = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    if D is not None:
        y = y + (D[:, None] * x.float()).to(y.dtype)
    return y, h
