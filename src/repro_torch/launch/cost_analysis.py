"""Per-device cost of one eager step: the port's counterpart of
``repro/launch/hlo_analysis.py``.

There is no HLO: :class:`CostCounter` is a ``TorchDispatchMode`` that
sees every ATen op the step runs.  For an op on DTensors it returns
``NotImplemented``, so DTensor runs the op as local ops on each rank's
shard (plus the collectives its redistributions run), and the counter
sees those: every number is per device, for the rank this process
stands for.  Ops on ``FakeTensor`` arguments are DTensor's sharding
propagation working out output shapes, not work; they are skipped.

  * ``flops``: dot and convolution FLOPs, by
    ``torch.utils.flop_counter``'s formulas, and the port's grouped
    product (``repro_torch::grouped_mm`` and its ``grouped_mm_wgrad``,
    the counterpart of ``lax.ragged_dot``) at 2 M K N each: every row
    counted, as the shapes give it (on ``meta`` the group sizes are not
    known); ``flops_by_op``: the same, by op name;
  * ``bytes``: operands plus result of each op -- the reference's per-op
    approximation; in eager mode each op is a kernel.  View and
    allocation-only ops move nothing;
  * ``collective_bytes`` / ``collective_by_kind``: the result bytes of
    each functional collective (all-gather, all-reduce, reduce-scatter,
    all-to-all);
  * ``unresolved_dots``: dot-like ops with no FLOP formula;
  * ``peak_bytes``: the peak of the bytes of live storages the step
    allocated (the arguments, allocated before, are not counted, nor is
    an in-place op's output).

The reference's ``trip_counts`` has no counterpart: an eager step has no
while loops, every iteration is counted as it runs.
"""
from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# functional collectives (and c10d's own ops) by kind, matched on the op name
_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")
# dot-like ops: counted by flop_registry, else unresolved
_DOTS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
         "vdot", "linear", "convolution", "_convolution", "_grouped_mm",
         "_scaled_mm"}
# the port's own dot-like ops (custom ops in the "repro_torch" namespace):
# FLOPs from the operand shapes.  grouped_mm(x (M, K), w, ends, trans_w)
# -> (M, N); grouped_mm_wgrad(x (M, K), dy (M, N), ends) -> (E, K, N)
_PORT_FLOPS = {
    "grouped_mm": lambda x, w, ends, trans_w, out_val: (
        2 * x.shape[0] * x.shape[1] * out_val.shape[1]),
    "grouped_mm_wgrad": lambda x, dy, ends, out_val: (
        2 * x.shape[0] * x.shape[1] * dy.shape[1]),
}
# ops that move no bytes: allocation and metadata
_FREE = {"empty", "empty_like", "empty_strided", "detach", "alias",
         "lift_fresh", "wait_tensor", "_wrap_tensor_autograd",
         "_local_scalar_dense", "set_", "resize_", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func):
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    for key, kind in _COLLECTIVES:
        if key in name:
            return kind
    return None


class CostCounter(TorchDispatchMode):
    """Counts what the ops run under it cost one device (see the module
    docstring); read :meth:`result` after the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.flops_by_op: dict = {}
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.collective_by_kind: dict = {}
        self.unresolved_dots = 0
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def _free(self, key):
        self.live_bytes -= self._live.pop(key)

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it as local ops
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                  # sharding propagation, not work
        name = func._overloadpacket.__name__
        if func.is_view or name in _FREE:
            return out
        # an in-place op's output is its input's storage: not allocated
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in held:
                self._track(t)
        nbytes = sum(_nbytes(t) for t in ins + outs)
        self.bytes += nbytes
        kind = _collective_kind(func)
        if kind is not None:
            b = sum(_nbytes(t) for t in outs)
            self.collective_bytes += b
            self.collective_by_kind[kind] = (
                self.collective_by_kind.get(kind, 0) + b)
        elif func._overloadpacket in flop_registry:
            self._count(name, flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        elif func.namespace == "repro_torch" and name in _PORT_FLOPS:
            self._count(name, _PORT_FLOPS[name](*args, **kwargs,
                                                out_val=out))
        elif name in _DOTS:
            self.unresolved_dots += 1
        return out

    def _count(self, name: str, flops) -> None:
        self.flops += flops
        self.flops_by_op[name] = self.flops_by_op.get(name, 0) + flops

    def result(self) -> dict:
        return {"flops": float(self.flops),
                "flops_by_op": {k: float(v)
                                for k, v in self.flops_by_op.items()},
                "bytes": float(self.bytes),
                "collective_bytes": float(self.collective_bytes),
                "collective_by_kind": dict(self.collective_by_kind),
                "unresolved_dots": self.unresolved_dots,
                "peak_bytes": self.peak_bytes}


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; returns
    (its output, the counter's result)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.result()
