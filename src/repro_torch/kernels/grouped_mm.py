"""Grouped matrix product over rows sorted by group: the port's
counterpart of ``lax.ragged_dot`` as the reference's ``moe_ffn`` uses it
(``repro/models/layers.py:605-609``, an XLA op, not a Pallas kernel).

``grouped_mm(x (M, K), w (E, K, N), ends (E,) int32) -> (M, N)``: rows
``[ends[e - 1], ends[e])`` of ``x`` go through ``w[e]``; rows past
``ends[-1]`` give zeros; a group with no row costs no work.  ``ends`` is
read where it lies: on the card the kernel (``csrc/grouped_mm.cu``) reads
it, so the host never waits for the group sizes, and the grid comes from
the shapes alone.

Both entry points are ``torch.library`` custom ops in the
``repro_torch`` namespace, so they trace on ``meta`` (an empty result of
the right shape, no values read) and autograd follows them:

  * ``repro_torch::grouped_mm(x, w, ends, trans_w)``: with ``trans_w``,
    ``w`` is read as (E, N, K) and row r of group e gives ``x[r] @
    w[e].T`` (the input gradient's product, with no copy of ``w``);
  * ``repro_torch::grouped_mm_wgrad(x, dy, ends) -> (E, K, N)``: ``dw[e]
    = x[group e].T @ dy[group e]``, zeros for an empty group.

On the CPU each takes its plain version (the ends read on the host, one
``seg @ w[e]`` per non-empty group, in ascending group order); on a CUDA
tensor it launches the kernel or raises.  :func:`grouped_mm_ref` and
:func:`grouped_mm_wgrad_ref` are the plain versions the tests and
``chip_smoke.py`` hold the kernels against.

The bf16 kernels run a persistent grid over a list of work units that
each CTA derives from ``ends`` on the card; :func:`tile_walk` is that
list's plain specification (the order, the tiles, the K splits), and
:func:`fwd_splits` / :func:`fwd_ctas` / :func:`wgrad_ctas` give the
split count and the grid from the shapes and the SM count alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import (DTYPE_CODES, build, on_cpu, raise_on_error,
                                 stream_ptr)

# kernel launches since the last reset (plain calls excluded)
launches = 0          # grouped_mm, forward and input gradient
wgrad_launches = 0    # grouped_mm_wgrad

ALIGN = 8             # K and N: whole 16-byte copies of bf16 rows

# The bf16 kernels' tiles (csrc/grouped_mm.cu).  Forward: FWD_COLS weight
# columns by up to FWD_ROWS of a group's rows, FWD_K of K a stage, x read
# in the smallest box of ROW_BOXES rows that holds the tile's rows.
# Weight gradient: WG_TILE x WG_TILE of dw, WG_ROWS of the group a stage.
# tests/test_torch_grouped_mm.py runs that source's kernels on the CPU
# (tools/cuda_emu) and holds the units they take to tile_walk(), so these
# stay the kernel's own.
FWD_COLS, FWD_ROWS, FWD_K = 128, 128, 64
ROW_BOXES = (16, 32, 64, 128)
WG_TILE, WG_ROWS = 128, 32
# K splits (forward): enough units for SPLIT_WAVES per SM at the most
# tiles the shapes allow, each split at least MIN_SPLIT_STAGES stages
SPLIT_WAVES, MIN_SPLIT_STAGES = 16, 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _most_row_tiles(M: int, E: int) -> int:
    """An upper bound on sum over groups of ceil(rows / FWD_ROWS): each
    non-empty group adds at most one partial tile."""
    return min(E, M) + _cdiv(M, FWD_ROWS)


def fwd_splits(M: int, K: int, N: int, E: int, sms: int) -> int:
    """The forward's K split count, from the shapes and the SM count."""
    tiles = _most_row_tiles(M, E) * _cdiv(N, FWD_COLS)
    want = SPLIT_WAVES * sms // tiles
    return max(1, min(want, _cdiv(K, FWD_K) // MIN_SPLIT_STAGES))


def fwd_ctas(M: int, N: int, E: int, splits: int, sms: int) -> int:
    """The forward's grid: one CTA per SM, fewer when the shapes allow
    fewer units (the tail's zero tiles included when splits == 1)."""
    nct = _cdiv(N, FWD_COLS)
    most = _most_row_tiles(M, E) * nct * splits
    if splits == 1:
        most += _cdiv(M, FWD_ROWS) * nct
    return max(1, min(sms, most))


def wgrad_ctas(K: int, N: int, E: int, sms: int) -> int:
    """The weight gradient's grid: one CTA per SM, at most one per tile."""
    return max(1, min(sms, E * _cdiv(K, WG_TILE) * _cdiv(N, WG_TILE)))


class WorkItem(NamedTuple):
    """One work unit of a bf16 kernel.

    Forward: rows ``[r0, r1)`` of group ``expert`` (``expert == E``: rows
    past ``ends[-1]``, written as zeros, ``k0 == k1 == 0``), output
    columns ``[n0, n1)``, the contraction over K ``[k0, k1)`` of split
    ``split``, x read in a box of ``box`` rows.  Weight gradient: ``dw
    [expert]`` rows ``[k0, k1)`` and columns ``[n0, n1)``, summed over the
    group's rows ``[r0, r1)`` (empty: a tile of zeros), ``box`` rows a
    stage."""
    expert: int
    r0: int
    r1: int
    k0: int
    k1: int
    n0: int
    n1: int
    split: int
    box: int


def group_rows(ends, M: int) -> list[tuple[int, int]]:
    """Rows [lo, hi) of each group, then of the tail past ends[-1], clamped
    as the kernels clamp them (0 <= lo <= hi <= M)."""
    b = [int(v) for v in ends]
    out = []
    for e in range(len(b) + 1):
        if e == len(b):
            lo, hi = b[-1], M
        else:
            lo, hi = (b[e - 1] if e else 0), b[e]
        lo = min(max(lo, 0), M)
        out.append((lo, min(max(hi, lo), M)))
    return out


def tile_walk(ends, M: int, K: int, N: int, *, wgrad: bool = False,
              splits: int = 1) -> list[WorkItem]:
    """The bf16 kernels' work units in the order the CUDA scheduler makes
    them: unit u runs on CTA ``u % ctas`` as its ``u // ctas``-th unit.

    Forward: expert by expert (ascending), each with rows giving
    ceil(rows / FWD_ROWS) row tiles x ceil(N / FWD_COLS) column tiles x
    ``splits`` K splits, ordered column tile, then split, then row tile
    (the row tiles of one weight slab run side by side, so its bytes come
    from HBM about once); with ``splits == 1`` the tail past ``ends[-1]``
    follows as expert E, with ``splits > 1`` the sum pass writes it.
    Split s covers K blocks [s nkb / S, (s + 1) nkb / S) of FWD_K.
    Weight gradient: every expert, ceil(K / WG_TILE) x ceil(N / WG_TILE)
    tiles, K tile then N tile."""
    rows = group_rows(ends, M)
    E = len(rows) - 1
    items = []
    if wgrad:
        for e in range(E):
            lo, hi = rows[e]
            for k0 in range(0, K, WG_TILE):
                for n0 in range(0, N, WG_TILE):
                    items.append(WorkItem(e, lo, hi, k0, min(k0 + WG_TILE, K),
                                          n0, min(n0 + WG_TILE, N), 0,
                                          WG_ROWS))
        return items
    nkb = _cdiv(K, FWD_K)
    for e in range(E + 1 if splits == 1 else E):
        lo, hi = rows[e]
        S = 1 if e == E else splits
        for n0 in range(0, N, FWD_COLS):
            for s in range(S):
                for r0 in range(lo, hi, FWD_ROWS):
                    r1 = min(r0 + FWD_ROWS, hi)
                    box = next(b for b in ROW_BOXES if b >= r1 - r0)
                    k0, k1 = ((0, 0) if e == E else
                              (s * nkb // S * FWD_K,
                               min((s + 1) * nkb // S * FWD_K, K)))
                    items.append(WorkItem(e, r0, r1, k0, k1, n0,
                                          min(n0 + FWD_COLS, N), s, box))
    return items


def _sms(t) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _bounds(ends) -> list[int]:
    """[0, ends[0], .., ends[-1]], read to the host."""
    return [0] + [int(v) for v in ends.tolist()]


def grouped_mm_ref(x, w, ends, *, trans_w: bool = False):
    """x: (M, K); w: (E, K, N), or (E, N, K) with ``trans_w``; ends: (E,)
    non-decreasing, ``ends[-1] <= M``.  Returns (M, N) in x's dtype."""
    M = x.shape[0]
    N = w.shape[1] if trans_w else w.shape[2]
    b = _bounds(ends)
    ys = []
    for e in range(w.shape[0]):
        if b[e + 1] > b[e]:
            we = w[e].t() if trans_w else w[e]
            ys.append(x[b[e]:b[e + 1]] @ we)
    if M > b[-1]:
        ys.append(x.new_zeros(M - b[-1], N))
    return torch.cat(ys) if ys else x.new_zeros(M, N)


def grouped_mm_wgrad_ref(x, dy, ends):
    """x: (M, K); dy: (M, N); ends: (E,).  Returns dw (E, K, N) in x's
    dtype: ``x[group e].T @ dy[group e]``, zeros for an empty group."""
    b = _bounds(ends)
    dws = []
    for e in range(ends.shape[0]):
        if b[e + 1] > b[e]:
            dws.append(x[b[e]:b[e + 1]].t() @ dy[b[e]:b[e + 1]])
        else:
            dws.append(x.new_zeros(x.shape[1], dy.shape[1]))
    return torch.stack(dws)


def _check(name, floats, ends, dims) -> int:
    """Validate a CUDA launch; returns the dtype code."""
    dtype = floats[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} unsupported "
                        f"(float32 or bfloat16)")
    if any(t.dtype != dtype for t in floats):
        raise TypeError(f"{name}: mixed dtypes "
                        f"{sorted({str(t.dtype) for t in floats})}")
    if ends.dtype != torch.int32:
        raise TypeError(f"{name}: ends must be int32, got {ends.dtype}")
    if not all(t.is_contiguous() for t in (*floats, ends)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(n % ALIGN for n in dims):
        raise ValueError(f"{name}: K and N must be multiples of {ALIGN}, "
                         f"got {dims}")
    return DTYPE_CODES[dtype]


def _launch_mm(x, w, ends, trans_w):
    global launches
    M, K = x.shape
    E = w.shape[0]
    N = w.shape[1] if trans_w else w.shape[2]
    if w.shape != ((E, N, K) if trans_w else (E, K, N)) or ends.shape != (E,):
        raise ValueError(f"grouped_mm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, ends {tuple(ends.shape)} "
                         f"(trans_w={trans_w}) do not match")
    code = _check("grouped_mm", (x, w), ends, (K, N))
    y = x.new_empty(M, N)
    if M == 0:
        return y
    splits, ctas, part = 1, 1, None
    if x.dtype == torch.bfloat16:
        sms = _sms(x)
        splits = fwd_splits(M, K, N, E, sms)
        ctas = fwd_ctas(M, N, E, splits, sms)
        if splits > 1:      # f32 partials, summed in split order
            part = torch.empty(splits, M, N, dtype=torch.float32,
                               device=x.device)
    fn = build.library("grouped_mm").grouped_mm_launch
    err = fn(x.data_ptr(), w.data_ptr(), ends.data_ptr(), y.data_ptr(),
             None if part is None else part.data_ptr(), M, K, N, E,
             int(trans_w), code, splits, ctas, stream_ptr(x))
    raise_on_error("grouped_mm", err)
    launches += 1
    return y


def _launch_wgrad(x, dy, ends):
    global wgrad_launches
    M, K = x.shape
    N = dy.shape[1]
    E = ends.shape[0]
    if dy.shape[0] != M or ends.dim() != 1:
        raise ValueError(f"grouped_mm_wgrad: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, ends {tuple(ends.shape)} do "
                         f"not match")
    code = _check("grouped_mm_wgrad", (x, dy), ends, (K, N))
    dw = x.new_empty(E, K, N)
    ctas = wgrad_ctas(K, N, E, _sms(x)) if x.dtype == torch.bfloat16 else 1
    fn = build.library("grouped_mm").grouped_mm_wgrad_launch
    err = fn(x.data_ptr(), dy.data_ptr(), ends.data_ptr(), dw.data_ptr(), M,
             K, N, E, code, ctas, stream_ptr(x))
    raise_on_error("grouped_mm_wgrad", err)
    wgrad_launches += 1
    return dw


@torch.library.custom_op("repro_torch::grouped_mm", mutates_args=())
def _grouped_mm_op(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor,
                   trans_w: bool) -> torch.Tensor:
    if on_cpu(x, w, ends):
        return grouped_mm_ref(x, w, ends, trans_w=trans_w)
    return _launch_mm(x, w, ends, trans_w)


@_grouped_mm_op.register_fake
def _(x, w, ends, trans_w):
    return x.new_empty(x.shape[0], w.shape[1] if trans_w else w.shape[2])


@torch.library.custom_op("repro_torch::grouped_mm_wgrad", mutates_args=())
def _grouped_mm_wgrad_op(x: torch.Tensor, dy: torch.Tensor,
                         ends: torch.Tensor) -> torch.Tensor:
    if on_cpu(x, dy, ends):
        return grouped_mm_wgrad_ref(x, dy, ends)
    return _launch_wgrad(x, dy, ends)


@_grouped_mm_wgrad_op.register_fake
def _(x, dy, ends):
    return x.new_empty(ends.shape[0], x.shape[1], dy.shape[1])


def _setup(ctx, inputs, output):
    x, w, ends, trans_w = inputs
    ctx.save_for_backward(x, w, ends)
    ctx.trans_w = trans_w


def _backward(ctx, dy):
    x, w, ends = ctx.saved_tensors
    dy = dy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        # y = x w[e] -> dx = dy w[e]^T; y = x w[e]^T -> dx = dy w[e]
        dx = _grouped_mm_op(dy, w, ends, not ctx.trans_w)
    if ctx.needs_input_grad[1]:
        dw = (_grouped_mm_wgrad_op(dy, x, ends) if ctx.trans_w
              else _grouped_mm_wgrad_op(x, dy, ends))
    return dx, dw, None, None


_grouped_mm_op.register_autograd(_backward, setup_context=_setup)


def grouped_mm(x, w, ends):
    """``lax.ragged_dot(x, w, group_sizes)`` with the group sizes given as
    their running sums ``ends`` (int32, on x's device).  Differentiable
    in x and w."""
    return _grouped_mm_op(x, w, ends, False)


def grouped_mm_wgrad(x, dy, ends):
    """The weight gradient of :func:`grouped_mm`: (E, K, N)."""
    return _grouped_mm_wgrad_op(x, dy, ends)
