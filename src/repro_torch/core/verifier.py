"""Speculative-decoding verification ("draft & verify", Fig 3).

The cloud LLM verifies a chunk of SLM draft tokens.  Two modes:

* greedy  -- accept while argmax(p_t) == draft_t; on mismatch the LLM's
             argmax replaces the rejected token.
* sample  -- Leviathan et al. 2023: accept x_t with prob min(1, p/q);
             on rejection resample from norm(max(p - q, 0)).

``verify_greedy`` / ``verify_sample`` are the host-numpy references
operating on full logits; ``verify_sample`` is exactly
distribution-preserving (we property-test this).  The serving hot path
uses the fused variants (``verify_greedy_ids`` / ``verify_sample_fused``)
consuming the engine's device-computed sparse rows: the accept test
still uses the EXACT full-softmax p(draft_t), but rejection resampling
and the bonus draw use the cloud's top-K sampling support — i.e. the
cloud's sampling method becomes top-K, exact w.r.t. the full
distribution only when K >= vocab (the property-tested regime).  That
is the same support-compression argument the paper makes for the §4.2
uplink, applied to the accelerator->host boundary.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class VerifyResult:
    n_accepted: int          # tokens of the draft accepted (0..gamma)
    corrected: int | None    # replacement token at the rejection position
    bonus: int | None        # extra token sampled when all gamma accepted
    tokens: list             # final verified continuation


def verify_greedy_ids(draft: np.ndarray, token_ids: np.ndarray) -> VerifyResult:
    """Greedy verification from per-row argmax ids alone (the fused
    on-device epilogue's output — no logits ever reach the host).

    draft: (gamma,) int; token_ids: (gamma+1,) int where entry t is
    argmax of the row predicting draft[t] (entry gamma predicts the
    bonus token)."""
    gamma = len(draft)
    tops = np.asarray(token_ids)
    n = 0
    while n < gamma and tops[n] == draft[n]:
        n += 1
    if n == gamma:
        bonus = int(tops[gamma])
        return VerifyResult(n, None, bonus, list(draft) + [bonus])
    return VerifyResult(n, int(tops[n]), None, list(draft[:n]) + [int(tops[n])])


def verify_greedy(draft: np.ndarray, p_logits: np.ndarray) -> VerifyResult:
    """Host-numpy reference: draft (gamma,) int; p_logits (gamma+1, V)
    LLM logits where row t predicts draft[t] (row gamma predicts the
    bonus token).  Kept as the oracle the fused path is tested against."""
    return verify_greedy_ids(draft, np.argmax(p_logits, axis=-1))


def _softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def verify_sample(draft: np.ndarray, p_logits: np.ndarray,
                  q_probs_sparse, rng: np.random.Generator) -> VerifyResult:
    """Stochastic speculative verification.

    q_probs_sparse: list of (idx (k,), val (k,)) per draft position — the
    *compressed* SLM distribution (core/compression.py).  The values are
    the renormalized sampling distribution the device actually used, so
    verification is lossless w.r.t. the intended sampling method (§4.2).
    """
    gamma = len(draft)
    V = p_logits.shape[-1]
    p = _softmax(p_logits.astype(np.float64))
    for t in range(gamma):
        idx, val = q_probs_sparse[t]
        qt = dict(zip(np.asarray(idx).tolist(), np.asarray(val, np.float64).tolist()))
        q_x = qt.get(int(draft[t]), 1e-12)
        p_x = p[t, int(draft[t])]
        if rng.random() < min(1.0, p_x / q_x):
            continue
        # rejected at t: resample from norm(max(p - q, 0))
        residual = p[t].copy()
        for j, qv in qt.items():
            residual[j] = max(residual[j] - qv, 0.0)
        s = residual.sum()
        if s <= 0:
            corrected = int(np.argmax(p[t]))
        else:
            corrected = int(rng.choice(V, p=residual / s))
        return VerifyResult(t, corrected, None, list(draft[:t]) + [corrected])
    bonus = int(rng.choice(V, p=p[gamma]))
    return VerifyResult(gamma, None, bonus, list(draft) + [bonus])


def verify_sample_fused(draft: np.ndarray, p_draft: np.ndarray,
                        topk_rows, q_probs_sparse,
                        rng: np.random.Generator, vocab: int) -> VerifyResult:
    """Stochastic verification from the fused epilogue's sparse rows.

    p_draft: (gamma,) EXACT softmax probability of each draft token under
    the full-vocab LLM row (gathered on device) — the accept test is
    therefore identical to :func:`verify_sample`.
    topk_rows: list of (idx (K,), val (K,)) per row, len gamma+1 — the
    LLM's top-K sampling support.  Rejection resampling draws from
    norm(max(p_K - q, 0)) and the bonus token from p_K: exact when
    K >= vocab, otherwise the cloud's sampling method is top-K (the same
    support-compression argument as the §4.2 uplink).
    Consumes ``rng`` in the same order as :func:`verify_sample`, so the
    two produce identical decisions when K >= vocab.
    """
    gamma = len(draft)
    for t in range(gamma):
        idx, val = q_probs_sparse[t]
        qt = dict(zip(np.asarray(idx).tolist(),
                      np.asarray(val, np.float64).tolist()))
        q_x = qt.get(int(draft[t]), 1e-12)
        p_x = float(p_draft[t])
        if rng.random() < min(1.0, p_x / q_x):
            continue
        # rejected at t: resample from norm(max(p - q, 0)).  Tokens
        # outside the top-K support carry p = 0 under top-K sampling,
        # so the residual support is a subset of the top-K support.
        pi = np.asarray(topk_rows[t][0])
        pv = np.asarray(topk_rows[t][1], np.float64)
        if len(pi) >= vocab:
            # full support: dense form, rng-draw-identical to the
            # verify_sample reference (the property-tested regime)
            residual = np.zeros(vocab, np.float64)
            residual[pi] = pv
            for j, qv in qt.items():
                residual[j] = max(residual[j] - qv, 0.0)
            s = residual.sum()
            corrected = (int(pi[np.argmax(pv)]) if s <= 0
                         else int(rng.choice(vocab, p=residual / s)))
        else:
            # hot path: O(K) on the support — no vocab-sized host work
            res = pv - np.array([qt.get(int(j), 0.0) for j in pi])
            res = np.maximum(res, 0.0)
            s = res.sum()
            corrected = (int(pi[np.argmax(pv)]) if s <= 0
                         else int(pi[rng.choice(len(pi), p=res / s)]))
        return VerifyResult(t, corrected, None, list(draft[:t]) + [corrected])
    pi = np.asarray(topk_rows[gamma][0])
    pv = np.asarray(topk_rows[gamma][1], np.float64)
    if len(pi) >= vocab:
        p = np.zeros(vocab, np.float64)
        p[pi] = pv
        bonus = int(rng.choice(vocab, p=p / p.sum()))
    else:
        bonus = int(pi[rng.choice(len(pi), p=pv / pv.sum())])
    return VerifyResult(gamma, None, bonus, list(draft) + [bonus])


def fused_row_from_logits(logits_row: np.ndarray, target: int, top_k: int):
    """Host mirror of models/steps.fused_verify_epilogue for ONE
    full-logits row — used when the pre-draft row was produced by a
    prompt prefill (whose target token was unknown at prefill time).

    Returns (token_id, p_target, topk_idx, topk_val)."""
    lf = np.asarray(logits_row, np.float32)
    e = np.exp(lf - lf.max(), dtype=np.float32)  # f32 on purpose: mirrors
    probs = e / e.sum(dtype=np.float32)          # the device epilogue
    k = max(1, min(top_k, lf.shape[-1]))
    # O(V) partition + O(k log k) sort, not a full-vocab argsort
    part = np.argpartition(-probs, k - 1)[:k]
    order = part[np.argsort(-probs[part], kind="stable")].astype(np.int32)
    p_t = float(probs[target]) if target is not None and target >= 0 else 0.0
    return (int(np.argmax(lf)), p_t, order, probs[order].astype(np.float32))


# ---------------------------------------------------------------------------
# Batched tensor variant (the reference's ``jnp`` version, in torch).
# ---------------------------------------------------------------------------

def verify_greedy_batched(draft: torch.Tensor, p_logits: torch.Tensor):
    """draft: (B, gamma); p_logits: (B, gamma+1, V).

    Returns (n_accepted (B,), corrected (B,), bonus (B,)) where
    ``corrected`` is the replacement at the rejection position (valid when
    n_accepted < gamma) and ``bonus`` the extra token (valid otherwise).
    Ties in the argmax resolve to the first index, as in ``jnp.argmax``.
    """
    gamma = draft.shape[1]
    tops = torch.argmax(p_logits, dim=-1)           # (B, gamma+1)
    match = tops[:, :gamma] == draft                # (B, gamma)
    # first mismatch position (gamma if none)
    n_acc = torch.where(match.all(dim=1), gamma,
                        torch.argmin(match.to(torch.int32), dim=1))
    corrected = torch.gather(
        tops, 1, torch.clamp(n_acc, max=gamma - 1)[:, None])[:, 0]
    bonus = tops[:, gamma]
    return n_acc, corrected, bonus


def expected_accepted(alpha: float, gamma: int) -> float:
    """E[#generated] for per-token acceptance alpha (capped geometric,
    Leviathan eq. 1): (1 - alpha^{gamma+1}) / (1 - alpha)."""
    if alpha >= 1.0:
        return gamma + 1.0
    return (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)


def alpha_from_expected(e_gen: float, gamma: int) -> float:
    """Invert expected_accepted by bisection (profiling §5)."""
    lo, hi = 1e-6, 1.0 - 1e-9
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if expected_accepted(mid, gamma) < e_gen:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
