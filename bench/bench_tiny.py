"""Tiny variants of the benchmark's configurations and traffic for the
CPU tests: the same families and code paths at widths a test run holds
(2 layers, hidden 64, vocab 512; 4 slots of 256 positions; 4 streams
with short prompts), in float32.  The ``wide`` variant (8 layers,
hidden 256, vocab 4096) is deep and wide enough that the fp8 control's
rounding reaches the size it has at the published widths."""
from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
SECONDS = 3.0   # a tiny run's window


def config(name: str, wide: bool = False) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    d, layers, vocab = (256, 8, 4096) if wide else (64, 2, 512)
    cfg.update(hidden_size=d, num_attention_heads=4, head_dim=d // 4,
               num_key_value_heads=2 if cfg.get("num_experts") else 4,
               intermediate_size=2 * d, vocab_size=vocab,
               num_hidden_layers=layers)
    if cfg.get("num_experts"):
        cfg.update(num_experts=8, num_experts_per_tok=2,
                   moe_intermediate_size=32)
    cfg["serve"] = {"slots": 4, "s_max": 256, "chunk": 32}
    cfg["check"] = dict(cfg["check"], served_tokens=120 if wide else 60,
                        max_tokens=8000, min_tokens_checked=10)
    return cfg


def traffic(name: str = "chat") -> dict:
    spec = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    spec.update(streams=4, block=8, ramp_s=0.3, trace_s=0.3)
    spec["prompt_tokens"] = {"dist": "uniform", "min": 8, "max": 40}
    spec["output_tokens"] = {"dist": "uniform", "min": 8, "max": 40}
    spec["device_tokens"] = dict(spec["device_tokens"], chunk=2,
                                 max_chunks=3)
    return spec


def run(name: str, seed: int = 5, wide: bool = False, **kw) -> dict:
    """One tiny run of ``name``'s configuration under tiny chat traffic
    on the CPU, in float32, on one intra-op thread: the window is wall
    time, and test workers that each start a thread per core would slow
    one another until too few sessions finish in it."""
    import torch

    import bench_harness as H
    kw.setdefault("seconds", SECONDS)
    kw.setdefault("trace", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return H.run_cell(config(name, wide),
                          kw.pop("spec", None) or traffic(), seed=seed,
                          metrics=["served_tokens_per_s"],
                          per_layer=kw.pop("per_layer", []), device="cpu",
                          dtype="float32", **kw)
    finally:
        torch.set_num_threads(threads)
