"""Weight bridge: the reference's parameter tree -> the port's tensors.

The input is the reference parameter tree as numpy arrays, either nested
(``jax.tree.map(np.asarray, repro.models.model.init_params(...))``) or
flat with ``||``-joined keys (a ``repro/checkpoint/io.py`` ``.npz``
loaded with ``numpy.load``).  The output is the nested dict the port's
``models/model.py`` consumes: same keys, the stacked leading layer axis
kept.  Leaves the reference keeps in float32 whatever the model dtype
(the Mamba2 ``A_log``, ``D`` and ``dt_bias``, and the MoE ``router``)
stay float32 when ``dtype=`` is given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime import resolve_device
from repro_torch.tree import unflatten

SEP = "||"   # key separator of repro/checkpoint/io.py
# the f32 leaves of layers.init_mamba and layers.init_moe
F32_LEAVES = ("A_log", "D", "dt_bias", "router")


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
    (default CUDA), cast to ``dtype`` when given (except the
    ``F32_LEAVES``)."""
    dev = resolve_device(device)
    if not any(isinstance(v, dict) for v in tree.values()) and any(
            SEP in k for k in tree):
        tree = unflatten([k.split(SEP) for k in tree], tree.values())

    def conv(node, name=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return _to_tensor(node, dev, None if name in F32_LEAVES else dtype)

    return conv(dict(tree))


def params_to_reference(params) -> dict:
    """The inverse: a nested dict of float32 numpy arrays (for checks)."""
    return {k: params_to_reference(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy() for k, v in params.items()}
