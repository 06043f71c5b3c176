"""AdamW, a cosine schedule and global-norm clipping over the port's
nested-dict parameter trees (port of ``repro/optim/adamw.py``).

Decoupled weight decay on every leaf with two or more axes, which takes
in the stacked per-layer norm weights (``layers.ln1``: (L, d)) but not
``final_norm``; so the optimizer acts on the stacked leaves, never on
per-layer slices.  Moments are stored in ``state_dtype``; the update's
arithmetic runs in float32, under ``torch.no_grad()``.  The global norm
sums the leaves in the reference's order (:mod:`repro_torch.tree`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates taken
    mu: dict
    nu: dict


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine decay to ``min_frac *
    base_lr`` at ``total``; computed in float32, as the reference."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))`` (in
    float32, back to each leaf's dtype).  Returns (grads, norm)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


class AdamW:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 max_grad_norm=1.0, schedule=None,
                 state_dtype=torch.float32):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule or (lambda s: lr)
        # bf16 moments for the largest MoE configs (the reference's note)
        self.state_dtype = state_dtype

    def init(self, params: dict) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.state_dtype,
                               device=p.device)
        dev = leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """(grads, state, params) -> (params, state, {"grad_norm", "lr"});
        new trees, the inputs untouched."""
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state.step + 1
        lr_t = self.schedule(step)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            mhat = m_new / c1
            vhat = v_new / c2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            # decoupled weight decay only on matrices (>= 2 axes)
            wd = self.weight_decay if p.dim() >= 2 else 0.0
            pf = p.float()
            p_new = pf - lr_t * (delta + wd * pf)
            return (p_new.to(p.dtype), m_new.to(self.state_dtype),
                    v_new.to(self.state_dtype))

        out = tree_map(upd, grads, state.mu, state.nu, params)

        def part(i):
            return tree_map(lambda t: t[i], out)
        lr_out = torch.as_tensor(lr_t, dtype=torch.float32,
                                 device=gnorm.device)
        return part(0), AdamWState(step=step, mu=part(1), nu=part(2)), {
            "grad_norm": gnorm, "lr": lr_out}
