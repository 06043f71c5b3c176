"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

A copy of ``repro/configs/qwen3_moe_235b_a22b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

QWEN3_MOE_235B = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,            # per-expert FFN dim
    vocab=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    moe_every=1,          # every layer is MoE
    source="hf:Qwen/Qwen3-30B-A3B",
))
