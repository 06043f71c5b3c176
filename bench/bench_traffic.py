"""The one traffic generator: closed-loop device streams, each running
sessions back to back, every number read from a traffic file.

A session is a prompt and an output length.  The cloud prefills the
prompt and returns its first token; then each round the device sends
the tokens it accepted on its own since the cloud's cached frontier
(the cloud's last correction plus ``device_tokens`` new ones) and
``gamma`` draft tokens, and waits for the verdict.  The session ends
once its output length is committed.  Under selective offload the
device keeps each chunk of ``gamma`` drafts with the probability
``keep`` (one less the offload budget) and sends the first chunk it
does not keep: the kept chunks are the round's device tokens, so their
number is geometric, ``device_tokens = {"dist": "kept_chunks", "chunk",
"keep", "max_chunks"}``.

Every seed serves the same work: the sizes come in blocks of ``block``
sessions, every block holding the same ``block`` prompt lengths and
output lengths (evenly spaced quantiles of the stated distributions) in
an order shuffled once for all seeds, and each round's number of device
tokens comes from one sequence per session, also the same for all
seeds.  The seed draws the token ids (prompts, device tokens, drafts)
and, in the harness, the weights.  Sizes in an order drawn from the
seed made the cells' tails swing between seeds by far more than between
two runs of one seed: a prefill pads every slot to its longest prompt,
so which prompts share a batch sets the tail.  A session is the same
whichever stream serves it.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ORDER_SEED = 0x5E55  # the one order of sizes and rounds, for every seed


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` evenly spaced quantiles, (i + 0.5) / n, of a length
    distribution: ``{"dist": "exponential", "mean", "min", "max"}``
    (rounded, then clipped) or ``{"dist": "uniform", "min", "max"}``
    (whole numbers, both ends included)."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "exponential":
        v = np.rint(-float(dist["mean"]) * np.log1p(-u))
    elif dist["dist"] == "uniform":
        v = lo + np.floor(u * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(v, lo, hi).astype(np.int64)


@dataclass
class Session:
    index: int
    prompt: np.ndarray        # token ids
    output: int               # output tokens to commit
    sizes: np.random.Generator  # its rounds' sizes (the same every seed)
    ids: np.random.Generator    # its token ids (from the seed)


class Traffic:
    """Sessions and rounds of one traffic file for one seed."""

    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec = spec
        self.vocab = vocab
        self.seed = int(seed) % 2**63
        self.streams = int(spec["streams"])
        self.gamma = int(spec["gamma"])
        self.block = int(spec["block"])
        self._prompts = quantiles(spec["prompt_tokens"], self.block)
        self._outputs = quantiles(spec["output_tokens"], self.block)
        self._dev = spec["device_tokens"]
        self._blocks: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _sizes(self, b: int):
        if b not in self._blocks:
            rng = np.random.default_rng([ORDER_SEED, 1, b])
            self._blocks[b] = (rng.permutation(self._prompts),
                               rng.permutation(self._outputs))
        return self._blocks[b]

    def session(self, i: int) -> Session:
        prompts, outputs = self._sizes(i // self.block)
        ids = np.random.default_rng([self.seed, 2, i])
        n = int(prompts[i % self.block])
        prompt = ids.integers(0, self.vocab, n, dtype=np.int64)
        return Session(i, prompt, int(outputs[i % self.block]),
                       np.random.default_rng([ORDER_SEED, 3, i]), ids)

    def first_output(self, session: Session, stream: int) -> int:
        """A stream's first session commits only a share of its output,
        (stream + 0.5) / streams, so that the streams' sessions end at
        spread-out times from the start."""
        return max(1, int(round(session.output * (stream + 0.5)
                                / self.streams)))

    def device_max(self) -> int:
        """The most device tokens a round can carry."""
        return int(self._dev["chunk"]) * int(self._dev["max_chunks"])

    def _device_count(self, sizes: np.random.Generator) -> int:
        d = self._dev
        if d["dist"] != "kept_chunks":
            raise ValueError(f"unknown device-token distribution "
                             f"{d['dist']!r}")
        kept = int(sizes.geometric(1.0 - float(d["keep"]))) - 1
        return int(d["chunk"]) * min(kept, int(d["max_chunks"]))

    def round(self, session: Session) -> tuple[np.ndarray, np.ndarray]:
        """(new device-accepted tokens, draft tokens) of the next round."""
        n = self._device_count(session.sizes)
        dev = session.ids.integers(0, self.vocab, n, dtype=np.int64)
        draft = session.ids.integers(0, self.vocab, self.gamma,
                                     dtype=np.int64)
        return dev, draft

    def longest_stream(self) -> int:
        """Tokens a session's stream can reach: its prompt, its output,
        the last round's overshoot and the drafts written past it."""
        return (int(self.spec["prompt_tokens"]["max"])
                + int(self.spec["output_tokens"]["max"])
                + self.device_max() + 2 * self.gamma + 1)


def load(bench_dir: Path, name: str) -> dict:
    return json.loads((Path(bench_dir) / "traffic" / f"{name}.json")
                      .read_text())
