"""glm4-9b [dense] — RoPE, GQA. [hf:THUDM/glm-4-9b]

A copy of ``repro/configs/glm4_9b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

GLM4_9B = register(ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    qkv_bias=True,       # GLM-4 uses QKV bias
    rope_theta=10_000.0,
    source="hf:THUDM/glm-4-9b",
))
