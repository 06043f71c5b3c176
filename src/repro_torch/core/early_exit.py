"""Progressive early exit inference (Synera §4.3).

* Layer-wise: compute a margin score (top-1 minus top-2 probability) from
  each eligible layer's hidden state; exit at the first layer whose margin
  exceeds the threshold.  Exits are allowed only in the last 25% of
  layers (conservative, per the paper).
* Sequence-wise: disable cloud offloading for t > gamma_seq * max_len.

The device step computes all layers and *selects* the exit layer, reporting
layers_executed to the latency model — the decision logic is the paper's,
the saving is modeled.  The decision runs on the host over the per-layer
logits the device step returns, in float32 as the reference computes it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class EarlyExitConfig:
    threshold: float = 0.7
    eligible_frac: float = 0.25   # exits allowed in the last 25% of layers
    seq_exit_frac: float = 0.8    # sequence-wise cutoff (gamma_seq)


def margin_scores(per_layer_logits):
    """per_layer_logits: (L, B, V) -> margin (L, B) = top1 - top2 prob."""
    x = np.asarray(per_layer_logits, np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    top2 = np.partition(probs, -2, axis=-1)[..., -2:]     # (L, B, 2)
    return top2[..., 1] - top2[..., 0]


def pick_exit_layer(per_layer_logits, n_layers: int, ee: EarlyExitConfig):
    """Select the exit layer per batch element.

    per_layer_logits: (L, B, V) logits computed from the hidden state
    after each transformer layer (L = n_layers).
    Returns (exit_layer (B,) int32, exit_logits (B, V), margin (L, B)).
    """
    logits = np.asarray(per_layer_logits)
    L = logits.shape[0]
    margins = margin_scores(logits)  # (L, B)
    first_eligible = int(math.ceil((1.0 - ee.eligible_frac) * n_layers)) - 1
    first_eligible = max(min(first_eligible, L - 1), 0)

    layer_idx = np.arange(L)[:, None]
    eligible = (layer_idx >= first_eligible) & (margins > ee.threshold)
    # first eligible layer, else last layer
    any_exit = eligible.any(axis=0)
    first_hit = np.argmax(eligible, axis=0)
    exit_layer = np.where(any_exit, first_hit, L - 1).astype(np.int32)

    B = logits.shape[1]
    exit_logits = logits[exit_layer, np.arange(B)]
    return exit_layer, exit_logits, margins


def layers_saved(exit_layer, n_layers: int):
    """Fraction of layer compute skipped (feeds the latency model)."""
    return (n_layers - 1 - exit_layer) / n_layers


def sequence_exit_active(t: int, max_len: int, ee: EarlyExitConfig) -> bool:
    """True when offloading should be disabled (tail of the generation)."""
    return t > ee.seq_exit_frac * max_len
