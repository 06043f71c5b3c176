"""Mamba2 SSD chunked scan (state-space duality).

Port of ``repro/kernels/ssd_scan/ssd_scan.py`` (``ssd_scan``), its oracle
``ref.py`` (``ssd_scan_ref``) and its wrapper ``ops.py`` (``ssd``, which
adds the D skip term).  :func:`ssd_scan_ref` is the plain version: the
sequence padded to a multiple of ``Q = min(chunk, L)`` with dt = 0 (a
no-op on the state), then the model path's ``ssd_chunked``.

The CUDA kernel (``csrc/ssd_scan.cu``) runs the standard SSD split as
four passes, each with its plain version here: :func:`ssd_chunk_cumsum`
and :func:`ssd_chunk_scores` (C Bᵀ once for all heads), then
:func:`ssd_chunk_states`, :func:`ssd_state_carry` (the only pass that is
sequential over chunks) and :func:`ssd_chunk_outputs`.
:func:`ssd_scan_passes` composes them; it equals :func:`ssd_scan_ref`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import (DTYPE_CODES, NEG_INF, build, on_cpu,
                                 raise_on_error, refuse_grad, stream_ptr)

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


def _chunked(t, Q):
    """(B, L, ...) -> (B, nc, Q, ...), rows past L zero."""
    B, L = t.shape[:2]
    nc = -(-L // Q)
    t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, nc * Q - L))
    return t.reshape(B, nc, Q, *t.shape[2:])


def ssd_chunk_cumsum(dt, A, *, chunk: int):
    """dAc (B, nc, Q, H) f32: within each chunk of ``Q = min(chunk, L)``
    rows, the running sum of dt * A, taken in order in f32 with the
    product rounded before the add (as the kernel does, and as
    ``torch.cumsum`` runs on the card; on the CPU it sums in double).
    Rows past L add dt = 0."""
    Q = min(chunk, dt.shape[1])
    dA = _chunked(dt.float(), Q) * A
    out = torch.empty_like(dA)
    acc = torch.zeros_like(dA[:, :, 0])
    for j in range(Q):
        acc = acc + dA[:, :, j]
        out[:, :, j] = acc
    return out


def ssd_chunk_scores(Bm, Cm, *, chunk: int):
    """C Bᵀ of each chunk, (B, nc, Q, Q) f32: shared by every head, so
    the kernel forms it once per (batch, chunk).  Only j <= i is read."""
    Q = min(chunk, Bm.shape[1])
    Bc, Cc = _chunked(Bm.float(), Q), _chunked(Cm.float(), Q)
    return Cc @ Bc.transpose(-1, -2)


def ssd_chunk_states(x, dt, Bm, dAc, *, chunk: int):
    """Each chunk's own contribution to the state, x^T (B o w) with w =
    exp(dAc_last - dAc) dt: (B, nc, H, P, N) f32."""
    Q = dAc.shape[2]
    xc, dtc = _chunked(x.float(), Q), _chunked(dt.float(), Q)
    w = torch.exp(dAc[:, :, -1:] - dAc) * dtc                 # (B, nc, Q, H)
    xw = (xc * w[..., None]).permute(0, 1, 3, 4, 2)          # (B, nc, H, P, Q)
    return xw @ _chunked(Bm.float(), Q)[:, :, None]


def ssd_state_carry(states, dAc, h0=None):
    """The state entering each chunk, (B, nc, H, P, N), and the final
    state (B, H, P, N), f32: h <- h exp(dAc_last) + the chunk's
    contribution, from h0 or 0, in chunk order."""
    decay = torch.exp(dAc[:, :, -1])                         # (B, nc, H)
    h = (torch.zeros_like(states[:, 0]) if h0 is None else h0.float())
    h_in = []
    for c in range(states.shape[1]):
        h_in.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    return torch.stack(h_in, 1), h


def ssd_chunk_outputs(x, dt, Cm, scores, dAc, h_in, *, chunk: int):
    """y (B, L, H, P) in x's dtype: per chunk, M x with M = scores o Lmat
    o dt_j (Lmat[i, j] = exp(dAc_i - dAc_j) for j <= i, else 0, masked
    before the exp), plus exp(dAc_i) (C_i . h_in)."""
    B, L, H, P = x.shape
    Q = dAc.shape[2]
    xc, dtc = _chunked(x.float(), Q), _chunked(dt.float(), Q)
    Cc = _chunked(Cm.float(), Q)
    da = dAc.permute(0, 1, 3, 2)                             # (B, nc, H, Q)
    diff = da[..., :, None] - da[..., None, :]               # (.., H, i, j)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    lmat = torch.exp(torch.where(causal, diff, NEG_INF))
    M = scores[:, :, None] * lmat * dtc.permute(0, 1, 3, 2)[..., None, :]
    xh = xc.permute(0, 1, 3, 2, 4)                           # (B, nc, H, Q, P)
    y = M @ xh + (Cc[:, :, None] @ h_in.transpose(-1, -2)) * da.exp()[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(B, -1, H, P)[:, :L]
    return y.to(x.dtype)


def ssd_scan_passes(x, dt, A, Bm, Cm, *, chunk: int = 64, h0=None):
    """The CUDA kernel's four passes in plain PyTorch; same contract and
    result as :func:`ssd_scan_ref`."""
    dAc = ssd_chunk_cumsum(dt, A, chunk=chunk)
    scores = ssd_chunk_scores(Bm, Cm, chunk=chunk)
    states = ssd_chunk_states(x, dt, Bm, dAc, chunk=chunk)
    h_in, h = ssd_state_carry(states, dAc, h0)
    return ssd_chunk_outputs(x, dt, Cm, scores, dAc, h_in, chunk=chunk), h


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
    CUDA tensors (rows past L are read as dt = 0, never padded).  The
    kernel's four passes count as one launch.  It has no gradient: inputs
    under grad are refused on every device (``mamba_block`` takes
    :func:`ssd_scan_ref` for them)."""
    global launches
    args = (x, dt, A, Bm, Cm) + ((h0,) if h0 is not None else ())
    refuse_grad("ssd_scan", *args)
    if on_cpu(*args):
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    code = _check(x, dt, A, Bm, Cm, h0, chunk)
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    nc, Qp = -(-L // Q), -(-Q // 16) * 16
    y = torch.empty_like(x)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # f32 scratch of the passes: C Bᵀ, dAc and w, the chunk states
    cb = torch.empty((B, nc, Qp, Qp), dtype=torch.float32, device=x.device)
    dac = torch.empty((2, B, nc, Qp, H), dtype=torch.float32,
                      device=x.device)
    st = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
    fn = build.library("ssd_scan").ssd_scan_launch
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), h0.data_ptr() if h0 is not None else None,
             y.data_ptr(), h_out.data_ptr(), cb.data_ptr(), dac[0].data_ptr(),
             dac[1].data_ptr(), st.data_ptr(), B, L, H, P, N, Q, code,
             stream_ptr(x))
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
