"""Hand-written Hopper kernels and their plain PyTorch versions.

One module per kernel of the reference's ``repro/kernels``; all six of
its Pallas entry points are carried: ``decode_gqa`` and
``partial_prefill`` (each a dense and a paged entry point; ``paged``
holds the block-table layout arithmetic and split merge both share,
``splits`` the dense kernels' split-KV count and its plain partials),
``attn_importance``, and ``ssd_scan`` (the Mamba2 SSD scan).  Each entry
point has its wrapper, its plain PyTorch version and a launch counter.
The wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the CUDA kernel (``csrc/``, built by
``build.py`` at first use) or raises.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    all lie on one CUDA device (kernel).  Anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check_kernel_inputs(name: str, floats, ints) -> int:
    """Validate a CUDA launch: float tensors share one supported dtype,
    position tensors are int32, all are contiguous.  Returns the dtype
    code the C entry point takes."""
    dtype = floats[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} unsupported "
                        f"(float32 or bfloat16)")
    for t in floats:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: positions must be int32, got {t.dtype}")
    for t in (*floats, *ints):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    hd = floats[0].shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} unsupported ({HEAD_DIMS})")
    return DTYPE_CODES[dtype]


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would track ``tensors``: the reference's Pallas
    kernels have no gradient, and a CUDA kernel's output here has no
    ``grad_fn``, so a loss through it would train whatever precedes it
    with zero gradient, silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the reference's Pallas kernels have no gradient, and "
            f"neither have these; train with attn_impl='blocked' (or "
            f"'naive'), or call under torch.no_grad()")


def raise_on_error(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
