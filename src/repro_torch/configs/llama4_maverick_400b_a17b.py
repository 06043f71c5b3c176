"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Llama-4 interleaves dense and MoE FFN layers (moe_every=2) and adds a
shared expert on MoE layers; router is top-1.  "Early fusion" means
multimodal tokens enter the same token stream — for the text-only dry-run
this is shape-transparent.

A copy of ``repro/configs/llama4_maverick_400b_a17b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

LLAMA4_MAVERICK = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    moe_every=2,           # alternate dense / MoE
    n_shared_experts=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
