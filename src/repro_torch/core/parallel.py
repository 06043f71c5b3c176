"""Stall-free parallel inference (Synera §4.4).

While the cloud verifies a draft chunk, the device predicts the rejection
position r* from a confidence-adjusted capped-geometric distribution and
speculatively continues generation from a corrected prefix.  When the
cloud's verdict matches the prediction, the speculative tokens are kept
and the round-trip stall is masked.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def rejection_distribution(confidences: np.ndarray, alpha: float) -> np.ndarray:
    """P(r = t) for t in {0..gamma}; t = gamma means full acceptance.

    Base: capped geometric P_base(r=t) = (1-alpha) alpha^t (t < gamma),
    alpha^gamma at t = gamma.  Adjusted by each draft token's confidence:
    P_adj(r=t) = P_base(r=t) * (1 - c_t) — high confidence lowers the
    rejection probability at t (Fig 4a).  Normalized.
    """
    gamma = len(confidences)
    base = np.array([(1 - alpha) * alpha ** t for t in range(gamma)] +
                    [alpha ** gamma], np.float64)
    adj = base.copy()
    adj[:gamma] *= (1.0 - np.asarray(confidences, np.float64))
    # full-acceptance mass scales with the chunk's overall confidence
    adj[gamma] *= max(float(np.mean(confidences)), 1e-6)
    s = adj.sum()
    return adj / s if s > 0 else np.full(gamma + 1, 1.0 / (gamma + 1))


def predict_rejection(confidences: np.ndarray, alpha: float,
                      rng: np.random.Generator) -> int:
    """Sample r* from the adjusted distribution."""
    p = rejection_distribution(confidences, alpha)
    return int(rng.choice(len(p), p=p))


@dataclass
class PIState:
    """One in-flight parallel-inference speculation.

    ``alt_token`` is the token PI placed at position r*: for r* < gamma
    the sampled replacement for the predicted-rejected draft token; for
    r* == gamma (predicted full acceptance) the SLM's own prediction of
    the LLM's bonus token.
    """
    r_star: int                 # predicted rejection position
    alt_token: int              # token PI placed at r*
    tokens: list = None         # speculative continuation generated during the stall


def choose_alternative(top3_idx: np.ndarray, top3_val: np.ndarray,
                       draft_token: int, rng: np.random.Generator) -> int:
    """Pick the replacement token at the predicted rejection position from
    the SLM's top-3 candidates, excluding the rejected draft token."""
    mask = top3_idx != draft_token
    idx = top3_idx[mask]
    val = np.asarray(top3_val, np.float64)[mask]
    if len(idx) == 0:
        return int(draft_token)
    val = val / val.sum()
    return int(rng.choice(idx, p=val))


def merge(pi: PIState, n_accepted_cloud: int, cloud_token_at_r: int,
          gamma: int):
    """Compare prediction with the cloud verdict (§4.4).

    ``cloud_token_at_r`` is the token the cloud placed at r_cloud: the
    corrected token on rejection, or the bonus token on full acceptance.

    Returns (adopt_pi: bool, position_hit: bool).  ``position_hit`` is the
    paper's reported hit-rate metric (r* == r_cloud); adopting the PI
    tokens additionally requires the token at r* to match, so the merged
    stream is always identical to the vanilla pipeline's output.
    """
    r_cloud = n_accepted_cloud
    position_hit = (pi.r_star == r_cloud)
    if not position_hit:
        return False, False
    return pi.alt_token == cloud_token_at_r, True
