"""Read the reference's checkpoints (``repro/checkpoint/io.py``) into the
port's parameters, with numpy only.

A checkpoint is one ``.npz`` whose keys are the parameter tree's leaf
paths joined by ``"||"`` (``embed``, ``layers||attn||wq``, ...).
``repro_torch.bridge`` turns the flat mapping into the port's nested
tensors.
"""
from __future__ import annotations

import numpy as np

from repro_torch import bridge
from repro_torch.models.model import torch_dtype


def _leaf(a: np.ndarray) -> np.ndarray:
    """``numpy.savez`` keeps a bfloat16 leaf as raw 2-byte records; widen
    those bits to the float32 they encode (exact)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def load(path: str, cfg, *, device=None) -> dict:
    """Parameters of ``cfg`` from the checkpoint at ``path``, on
    ``device`` (default CUDA), in the config's dtype."""
    with np.load(path) as data:
        flat = {k: _leaf(data[k]) for k in data.files}
    return bridge.params_from_reference(flat, device=device,
                                        dtype=torch_dtype(cfg))
