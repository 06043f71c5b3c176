"""Weight bridge: the reference's parameter tree -> the port's tensors.

The input is the reference parameter tree as numpy arrays, either nested
(``jax.tree.map(np.asarray, repro.models.model.init_params(...))``) or
flat with ``||``-joined keys (a ``repro/checkpoint/io.py`` ``.npz``
loaded with ``numpy.load``).  The output is the nested dict the port's
``models/model.py`` consumes: same keys, the stacked leading layer axis
kept.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime import resolve_device

SEP = "||"   # key separator of repro/checkpoint/io.py


def _unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat:
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree


def _to_tensor(a, device, dtype):
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16 (jax's)
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_reference(tree, *, device=None, dtype=None) -> dict:
    """Convert a reference parameter tree (nested dict, or flat mapping
    with ``||`` keys) of numpy arrays into torch tensors on ``device``
    (default CUDA), cast to ``dtype`` when given."""
    dev = resolve_device(device)
    if not any(isinstance(v, dict) for v in tree.values()) and any(
            SEP in k for k in tree):
        tree = _unflatten(tree)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    return conv(dict(tree))


def params_to_reference(params) -> dict:
    """The inverse: a nested dict of float32 numpy arrays (for checks)."""
    return {k: params_to_reference(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy() for k, v in params.items()}
