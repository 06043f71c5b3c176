"""Compression before transmission (Synera §4.2).

The verifier needs the draft tokens plus the SLM's probability
distribution at each draft position.  Transmitting the full distribution
is tens of thousands of floats (e.g. 32,000 for Llama-2); Synera sends
only the support of the *intended sampling method* (top-1 for greedy,
top-k, or top-p), which is lossless for verification and >99.5% smaller.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CompressedDist:
    idx: np.ndarray   # (k,) int32 token ids in the support
    val: np.ndarray   # (k,) float16 renormalized probabilities

    @property
    def nbytes(self) -> int:
        return int(self.idx.nbytes + self.val.nbytes)


def _softmax(x):
    x = x - x.max()
    e = np.exp(x, dtype=np.float64)
    return e / e.sum()


def compress(logits: np.ndarray, method: str = "top_k", k: int = 8,
             top_p: float = 0.9, temperature: float = 1.0) -> CompressedDist:
    """Compress one position's distribution to its sampling support."""
    probs = _softmax(logits.astype(np.float64) / max(temperature, 1e-6))
    if method == "greedy":
        idx = np.array([int(np.argmax(probs))], np.int32)
        val = np.array([1.0], np.float16)
        return CompressedDist(idx, val)
    if method == "top_k":
        idx = np.argpartition(probs, -k)[-k:].astype(np.int32)
        idx = idx[np.argsort(-probs[idx])]
    elif method == "top_p":
        order = np.argsort(-probs)
        cum = np.cumsum(probs[order])
        cut = int(np.searchsorted(cum, top_p) + 1)
        idx = order[:cut].astype(np.int32)
    else:
        raise ValueError(method)
    val = probs[idx]
    val = (val / val.sum()).astype(np.float16)
    return CompressedDist(idx, val)


def decompress(c: CompressedDist, vocab: int) -> np.ndarray:
    out = np.zeros(vocab, np.float64)
    out[c.idx] = c.val.astype(np.float64)
    s = out.sum()
    return out / s if s > 0 else out


def full_dist_bytes(vocab: int, dtype_bytes: int = 4) -> int:
    return vocab * dtype_bytes


def chunk_payload_bytes(dists: list[CompressedDist], n_tokens: int,
                        *, compressed: bool = True, vocab: int = 32000) -> int:
    """Uplink payload for one verification request: draft token ids +
    (compressed or full) distributions + small header."""
    header = 32
    tok_bytes = 4 * n_tokens
    if compressed:
        dist_bytes = sum(d.nbytes for d in dists)
    else:
        dist_bytes = full_dist_bytes(vocab) * len(dists)
    return header + tok_bytes + dist_bytes


def compression_ratio(dists: list[CompressedDist], vocab: int) -> float:
    full = full_dist_bytes(vocab) * len(dists)
    comp = sum(d.nbytes for d in dists)
    return 1.0 - comp / max(full, 1)
