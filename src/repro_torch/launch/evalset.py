"""Evaluation helpers of the serve launcher (a copy of the shared
machinery of ``benchmarks/paper_claims.py``: the constants, ``eval_set``,
``score_outputs``, ``make_device``, ``make_engine`` and ``profile_pair``;
the per-figure functions are not ported).

The prompts come from the synthetic task (``data/synthetic.py``) and are
scored against its exact ground truth.  ``make_device`` / ``make_engine``
take the port's ``device=`` (CUDA unless the caller passes ``"cpu"``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.profiling import fit_profile
from repro_torch.serving import synergy as SY
from repro_torch.serving.device import DeviceRuntime
from repro_torch.serving.engine import CloudEngine

GAMMA = 4
S_MAX = 192
PLEN = 40
GEN = 40


def eval_set(task, n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq, regimes = task.sample_sequence(PLEN + GEN, rng)
        out.append((list(map(int, seq[:PLEN])), regimes))
    return out


def score_outputs(task, evalset, outputs):
    scores = []
    for (prompt, regimes), toks in zip(evalset, outputs):
        full = np.array(prompt + [int(t) for t in toks])
        scores.append(task.score(full, regimes, PLEN))
    return {k: float(np.mean([s[k] for s in scores])) for k in scores[0]}


def make_device(slm_cfg, slm_p, policy=None, **kw):
    # wire_vocab: payload accounting at Llama-2 production vocab (§4.2)
    defaults = dict(s_max=S_MAX, gamma=GAMMA, seed=0, sampling="greedy",
                    wire_vocab=32_000)
    defaults.update(kw)
    return DeviceRuntime(slm_cfg, slm_p, policy=policy, **defaults)


def make_engine(llm_cfg, llm_p, slots: int = 2, attn_impl: str | None = None,
                verify_top_k: int = 8, cache_impl: str | None = None,
                block_size: int | None = None,
                pool_blocks: int | None = None,
                share_prefix: bool | None = None,
                swap: bool | None = None,
                host_swap_blocks: int | None = None,
                retain_prefix: bool | None = None,
                retain_blocks: int | None = None,
                host_dedupe: bool | None = None,
                paged_block_kv: int | None = None,
                kv_splits: int | None = None,
                device=None):
    cfg = llm_cfg if attn_impl is None else llm_cfg.replace(
        attn_impl=attn_impl)
    return CloudEngine(cfg, llm_p, max_slots=slots, s_max=S_MAX,
                       verify_top_k=verify_top_k, cache_impl=cache_impl,
                       block_size=block_size, pool_blocks=pool_blocks,
                       share_prefix=share_prefix, swap=swap,
                       host_swap_blocks=host_swap_blocks,
                       retain_prefix=retain_prefix,
                       retain_blocks=retain_blocks,
                       host_dedupe=host_dedupe,
                       paged_block_kv=paged_block_kv, kv_splits=kv_splits,
                       device=device)


def profile_pair(dev, eng, evalset, task):
    """Offline profiling (§5): offload-all calibration pass."""
    r = SY.run_synera(dev, eng, [p for p, _ in evalset], GEN,
                      profile_mode=True)
    recs = [c for m in r.metrics for c in m.chunk_records]
    return fit_profile(recs), r
