"""Synthetic language task with an *exact* ground-truth process (a copy
of ``repro/data/synthetic.py``).

The container has no datasets, so the paper's quality studies (Table 4,
Fig 5/11/14) are reproduced on a synthetic language whose conditional
distribution p*(x_t | history) is known in closed form:

* a regime-switching order-1 Markov chain (regime chosen by HEADER
  tokens, each regime has its own sparse bigram table), plus
* a deterministic long-range COPY rule: at every position with
  t % copy_every == 0 (t > copy_back), the correct token is the token
  copy_back steps earlier.

The copy rule requires carrying information across many steps — deeper /
wider models learn it markedly better than tiny ones, reproducing the
paper's SLM-vs-LLM capability gap (Table 3) at laptop scale.  Quality
metrics:
  * nll  — negative log-likelihood of generated text under p* (lower
           better; analogue of Rouge/BERTScore continuous quality)
  * copy_acc — accuracy on the deterministic copy positions (the
           "task accuracy" analogue, cf. CSQA/SST2 accuracy)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TaskSpec:
    vocab: int = 64           # includes regime HEADER tokens at the top
    n_regimes: int = 4
    branching: int = 4        # successors per token per regime
    copy_every: int = 16
    copy_back: int = 8
    regime_len: int = 64      # tokens between regime switches
    seed: int = 1234

    @property
    def base_vocab(self) -> int:
        return self.vocab - self.n_regimes

    def header(self, r: int) -> int:
        return self.base_vocab + r


class SyntheticTask:
    def __init__(self, spec: TaskSpec = TaskSpec()):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        V, R, B = spec.base_vocab, spec.n_regimes, spec.branching
        # sparse bigram tables: for each regime and token, `branching`
        # allowed successors with Dirichlet weights
        self.succ = rng.integers(0, V, size=(R, V, B))
        w = rng.dirichlet(np.ones(B) * 0.6, size=(R, V))
        self.succ_p = w  # (R, V, B)

    # ------------------------------------------------------------------
    def _regime_at(self, t: int, regime_seq: np.ndarray) -> int:
        return int(regime_seq[t // self.spec.regime_len])

    def true_dist(self, history: np.ndarray, t: int,
                  regime_seq: np.ndarray) -> np.ndarray:
        """p*(x_t | history). history: tokens x_0..x_{t-1}."""
        sp = self.spec
        V = sp.vocab
        p = np.zeros(V)
        if t % sp.regime_len == 0:
            p[sp.header(self._regime_at(t, regime_seq))] = 1.0
            return p
        if t % sp.copy_every == 0 and t >= sp.copy_back:
            p[int(history[t - sp.copy_back])] = 1.0
            return p
        r = self._regime_at(t, regime_seq)
        prev = int(history[t - 1])
        if prev >= sp.base_vocab:  # after a header: uniform over successors
            prev = 0
        # np.add.at: duplicate successors must accumulate
        np.add.at(p, self.succ[r, prev], self.succ_p[r, prev])
        return p

    def sample_sequence(self, length: int, rng: np.random.Generator):
        sp = self.spec
        n_blocks = length // sp.regime_len + 2
        regime_seq = rng.integers(0, sp.n_regimes, size=n_blocks)
        x = np.zeros(length, np.int64)
        for t in range(length):
            p = self.true_dist(x, t, regime_seq)
            x[t] = rng.choice(sp.vocab, p=p)
        return x, regime_seq

    def corpus(self, n_sequences: int, length: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        seqs, regimes = [], []
        for _ in range(n_sequences):
            x, r = self.sample_sequence(length, rng)
            seqs.append(x)
            regimes.append(r)
        return np.stack(seqs), regimes

    # ------------------------------------------------------------------
    # Quality metrics
    # ------------------------------------------------------------------
    def score(self, full_seq: np.ndarray, regime_seq: np.ndarray,
              start: int, nll_cap: float = 6.0) -> dict:
        """Score tokens full_seq[start:] generated as a continuation of
        full_seq[:start] under the true process.

        Token NLL is capped (impossible tokens would otherwise dominate
        the mean with -log(1e-12) spikes and make ``quality`` a coin
        flip on a single bad token — the cap makes it a robust
        Rouge/BERTScore-like continuous score in (e^-cap, 1]).
        """
        sp = self.spec
        nlls, copy_hits, copy_total, valid = [], 0, 0, 0
        for t in range(start, len(full_seq)):
            p = self.true_dist(full_seq, t, regime_seq)
            q = float(p[int(full_seq[t])])
            valid += int(q > 0)
            nlls.append(min(-np.log(max(q, 1e-12)), nll_cap))
            if t % sp.copy_every == 0 and t >= sp.copy_back \
                    and t % sp.regime_len != 0:
                copy_total += 1
                copy_hits += int(full_seq[t] == full_seq[t - sp.copy_back])
        return {
            "nll": float(np.mean(nlls)) if nlls else 0.0,
            "copy_acc": copy_hits / max(copy_total, 1),
            "quality": float(np.exp(-np.mean(nlls))) if nlls else 0.0,
            "valid_frac": valid / max(len(nlls), 1),
        }


def batches(corpus: np.ndarray, batch_size: int, seq_len: int, *,
            rng: np.random.Generator):
    """Infinite iterator of LM training batches from a corpus of
    (n_sequences, length) token arrays."""
    n, length = corpus.shape
    while True:
        rows = rng.integers(0, n, size=batch_size)
        starts = rng.integers(0, length - seq_len, size=batch_size)
        yield np.stack([corpus[r, s:s + seq_len]
                        for r, s in zip(rows, starts)])
