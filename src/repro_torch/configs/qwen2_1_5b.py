"""qwen2-1.5b [dense] — GQA, QKV bias. [arXiv:2407.10671]

A copy of ``repro/configs/qwen2_1_5b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

QWEN2_1_5B = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
))
