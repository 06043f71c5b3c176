"""Selective token-level offloading (Synera §4.2).

Two-stage dispatch over draft chunks of gamma tokens:
  1. ``p_conf`` (coarse): scaled sigmoid over the chunk's mean confidence
     (top-1 probability).  Retains the ~15% highly-confident chunks.
  2. ``p_imp``  (fine):   three-tier scaled sigmoid over the chunk's mean
     attention importance (column sums).  ``i_th`` is the runtime budget
     knob.

Both are exactly the paper's equations (Fig 9) with k=10, theta=-10.
They compute in float32, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def p_conf(c, c_th: float, k: float = 10.0):
    """Confidence dispatch probability.

    P_conf(c) = 1                          if c <= c_th
              = 1 / (1 + exp(k * norm(c))) otherwise,
    norm(c) = (c - c_th) / (1 - c_th) - 1/2.
    High confidence -> low dispatch probability.
    """
    c = np.asarray(c, np.float32)
    norm = (c - c_th) / max(1.0 - c_th, 1e-6) - 0.5
    sig = 1.0 / (1.0 + np.exp(k * norm))
    return np.where(c <= c_th, 1.0, sig)


def p_imp(i, i_th: float, theta: float = -10.0):
    """Importance dispatch probability (three tiers).

    P_imp(i) = 0                               if i <= i_th/2
             = 1                               if i >  i_th
             = 1 / (1 + exp(theta * norm(i)))  otherwise,
    norm(i) = (i - i_th/2) / (i_th/2) - 1/2.
    High importance -> high dispatch probability.  theta < 0.
    """
    i = np.asarray(i, np.float32)
    lo = i_th / 2.0
    norm = (i - lo) / max(lo, 1e-9) - 0.5
    sig = 1.0 / (1.0 + np.exp(theta * norm))
    return np.where(i <= lo, 0.0, np.where(i > i_th, 1.0, sig))


@dataclass
class OffloadPolicy:
    """Runtime offloading decision; parameters come from offline profiling
    (core/profiling.py).  ``i_th`` is the budget knob (§6.3)."""

    c_th: float = 0.8
    i_th: float = 0.5
    k: float = 10.0
    theta: float = -10.0
    # "both" | "conf" | "imp" | "random" | "all" | "none" | "chunk_set"
    mode: str = "both"
    random_rate: float = 0.2  # for the "random" ablation baseline
    # explicit chunk ordinals to offload (the paper's Fig 5 oracle
    # measurement protocol: rank chunks offline by full-context
    # importance, offload the top n%)
    chunk_set: frozenset = frozenset()

    def dispatch_probability(self, mean_conf: float, mean_imp: float):
        pc = p_conf(mean_conf, self.c_th, self.k)
        pi = p_imp(mean_imp, self.i_th, self.theta)
        if self.mode == "both":
            return pc * pi
        if self.mode == "conf":
            return pc
        if self.mode == "imp":
            return pi
        if self.mode == "random":
            return np.float32(self.random_rate)
        if self.mode == "all":
            return np.float32(1.0)
        if self.mode == "none":
            return np.float32(0.0)
        raise ValueError(self.mode)

    def should_offload(self, rng: np.random.Generator, mean_conf, mean_imp,
                       *, seq_pos: int = 0, max_len: int = 0,
                       seq_exit_frac: float = 0.0,
                       chunk_index: int = -1) -> bool:
        """Sample the offload decision for one draft chunk.

        Sequence-wise early exit (§4.3): never offload past
        seq_exit_frac * max_len.
        """
        if self.mode == "chunk_set":
            return chunk_index in self.chunk_set
        if seq_exit_frac and max_len and seq_pos > seq_exit_frac * max_len:
            return False
        p = float(self.dispatch_probability(mean_conf, mean_imp))
        return bool(rng.random() < p)


def importance_from_percentile(importance_samples: np.ndarray, budget: float) -> float:
    """Map an offloading budget (fraction of chunks sent to cloud) to the
    i_th cutoff: the (1 - budget) percentile of the profiled importance
    distribution (§5)."""
    budget = float(np.clip(budget, 0.0, 1.0))
    if budget >= 1.0:
        return 0.0
    if budget <= 0.0:
        return float(np.max(importance_samples) * 2 + 1e9)
    return float(np.quantile(importance_samples, 1.0 - budget))
