"""Offline Synera-aware profiling (Synera §5).

For each SLM-LLM pair we run a calibration pass with *all* chunks
offloaded (the synergy orchestrator's profile mode) and collect one
``ChunkRecord`` per draft chunk.  From these we fit:

* ``c_th``  -- mean confidence of fully-accepted chunks (coarse filter cutoff)
* ``i_th``  -- budget -> percentile of the importance distribution
* ``alpha`` -- per-token acceptance probability, from the capped-geometric
               expectation E[#generated] = (1 - a^(g+1)) / (1 - a)
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict

import numpy as np

from repro_torch.core.verifier import alpha_from_expected
from repro_torch.core.offload import importance_from_percentile


@dataclass
class ChunkRecord:
    mean_conf: float
    mean_imp: float
    n_accepted: int
    gamma: int

    @property
    def fully_accepted(self) -> bool:
        return self.n_accepted >= self.gamma


@dataclass
class SyneraProfile:
    c_th: float
    alpha: float
    gamma: int
    importance_samples: list = field(default_factory=list)
    conf_samples: list = field(default_factory=list)

    def i_th_for_budget(self, budget: float) -> float:
        """Calibrated budget knob: bisect i_th so the EXPECTED offload
        rate over the calibration chunks matches the budget.

        The paper sets i_th at the (1-budget) percentile of the
        importance distribution (§5); because P_imp's sigmoid mid-band
        admits sub-threshold chunks and P_conf ~ 1 for the
        under-confident majority, the raw percentile overshoots the
        target rate ~3x.  When conf samples are available we solve for
        the i_th whose expected dual-metric rate equals the budget
        (same offline data, same knob semantics)."""
        imps = np.asarray(self.importance_samples, np.float64)
        if not self.conf_samples:
            return importance_from_percentile(imps, budget)
        from repro_torch.core.offload import p_conf, p_imp
        confs = np.asarray(self.conf_samples, np.float64)
        pc = np.asarray(p_conf(confs, self.c_th))

        def rate(i_th):
            return float(np.mean(pc * np.asarray(p_imp(imps, i_th))))

        budget = float(np.clip(budget, 0.0, 1.0))
        lo, hi = 1e-9, float(imps.max()) * 4 + 1e-6
        if budget >= rate(lo):
            return lo
        if budget <= rate(hi):
            return hi
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if rate(mid) > budget:   # rate decreases as i_th grows
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "SyneraProfile":
        with open(path) as f:
            return cls(**json.load(f))


def fit_profile(records: list[ChunkRecord]) -> SyneraProfile:
    if not records:
        raise ValueError("no calibration records")
    gamma = records[0].gamma
    full = [r.mean_conf for r in records if r.fully_accepted]
    # cut-off confidence: mean confidence of fully-accepted chunks (§5);
    # fall back to a high quantile if nothing was fully accepted.
    if full:
        c_th = float(np.mean(full))
    else:
        c_th = float(np.quantile([r.mean_conf for r in records], 0.9))
    c_th = float(np.clip(c_th, 0.05, 0.999))

    # acceptance probability from expected accepted count (+1 bonus token
    # convention of Leviathan's E[#generated])
    e_gen = float(np.mean([min(r.n_accepted, gamma) for r in records])) + 1.0
    alpha = alpha_from_expected(e_gen, gamma)

    imps = [float(r.mean_imp) for r in records]
    confs = [float(r.mean_conf) for r in records]
    return SyneraProfile(c_th=c_th, alpha=alpha, gamma=gamma,
                         importance_samples=imps, conf_samples=confs)
