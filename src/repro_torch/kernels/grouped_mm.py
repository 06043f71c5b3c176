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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (DTYPE_CODES, build, on_cpu, raise_on_error,
                                 stream_ptr)

# kernel launches since the last reset (plain calls excluded)
launches = 0          # grouped_mm, forward and input gradient
wgrad_launches = 0    # grouped_mm_wgrad

ALIGN = 8             # K and N: whole 16-byte copies of bf16 rows


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
    fn = build.library("grouped_mm").grouped_mm_launch
    err = fn(x.data_ptr(), w.data_ptr(), ends.data_ptr(), y.data_ptr(), M, K,
             N, E, int(trans_w), code, stream_ptr(x))
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
    fn = build.library("grouped_mm").grouped_mm_wgrad_launch
    err = fn(x.data_ptr(), dy.data_ptr(), ends.data_ptr(), dw.data_ptr(), M,
             K, N, E, code, stream_ptr(x))
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
