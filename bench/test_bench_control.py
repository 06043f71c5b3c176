"""The check must fail what it is there to catch.  On the CPU, with each
configuration's own limits: the control (the reference computed in fp8,
in the program's place; at ``bench_tiny``'s wide size, where fp8's
rounding grows as it does at the published widths) comes out not
correct, and a run (at the tiny size) whose timed path is broken underneath comes out not
correct, once for each fault a cell of one chip can have:

* a step that returns its state unchanged (the KV cache never written);
* half of the batch left out (the upper half of the slots' rows dropped
  from every forward);
* a token altered where it is produced (the verify feed's argmax ids).

(The exchange between chips does not exist in a one-chip cell.)  A
sound run of the same seed comes out correct."""
import numpy as np
import pytest

import bench_harness as H
import bench_tiny

CONFIGS = ["qwen1.5-7b", "qwen3-moe-8l"]


def _fails_a_limit(cfg, gaps):
    numbers = H.gap_numbers(gaps)
    return any(numbers[n] > lim for n, lim in cfg["check"]["limits"].items())


@pytest.mark.parametrize("name", CONFIGS)
def test_sound_run_is_correct_and_control_is_not(name):
    res = bench_tiny.run(name, seed=21, wide=True, control=True)
    assert res["correct"], res["checks"]
    ctl = res["control"]
    assert ctl["control"].size == ctl["program"].size >= 20
    # the run's own verdict, applied to the control's numbers
    assert ctl["correct"] is False
    assert _fails_a_limit(bench_tiny.config(name, wide=True), ctl["control"])


def _unchanged_state(monkeypatch):
    from repro_torch.models import layers as L
    monkeypatch.setattr(L, "cache_write",
                        lambda cache, k, v, positions, index=None: cache)


def _half_batch(monkeypatch):
    from repro_torch.serving.engine import CloudEngine
    real = CloudEngine._run_fused

    def run_fused(self, tokens, positions, *args, **kw):
        half = self.max_slots // 2
        tokens, positions = tokens.copy(), positions.copy()
        tokens[half:], positions[half:] = 0, -1
        return real(self, tokens, positions, *args, **kw)

    monkeypatch.setattr(CloudEngine, "_run_fused", run_fused)


def _altered_token(monkeypatch):
    from repro_torch.serving.engine import CloudEngine, VerifyRows
    real = CloudEngine.feed

    def feed(self, *args, **kw):
        rows = real(self, *args, **kw)
        return VerifyRows(token_id=(rows.token_id + 1) % self.vocab,
                          p_draft=rows.p_draft, topk_idx=rows.topk_idx,
                          topk_val=rows.topk_val)

    monkeypatch.setattr(CloudEngine, "feed", feed)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_token": _altered_token}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    res = bench_tiny.run(name, seed=21)
    assert not res["correct"], res["checks"]
    assert np.isfinite(res["checks"]["tokens_checked"]["value"])
