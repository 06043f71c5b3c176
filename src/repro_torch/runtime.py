"""Device selection for the port's entry points.

Entry points take ``device=`` and default to CUDA.  A CUDA request on a
machine without a usable card raises; nothing falls back to the CPU.
Tests and other CPU callers pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA.  On CUDA, float32 matrix products and
    convolutions are pinned to full f32 (no TF32), the reference's
    precision."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
