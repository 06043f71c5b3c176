"""Checkpoints in the reference's format (``repro/checkpoint/io.py``),
written and read with numpy only.

A checkpoint is one ``.npz`` whose keys are the parameter tree's leaf
paths joined by ``"||"`` (``embed``, ``layers||attn||wq``, ...).  A
float32 leaf is stored as float32; a bfloat16 leaf as the raw 2-byte
records (``V2``) that ``numpy.savez`` makes of the reference's ml_dtypes
bfloat16 arrays, here without ml_dtypes.  ``repro_torch.bridge`` turns
the flat mapping into the port's nested tensors.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.models.model import torch_dtype
from repro_torch.tree import flatten


def _record(t: torch.Tensor) -> np.ndarray:
    """A leaf as the array the reference's ``save`` writes for it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save(path: str, params: dict) -> None:
    """Write ``params`` (the port's nested dict of tensors) to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{bridge.SEP.join(p): _record(leaf)
                      for p, leaf in flatten(params)})


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
