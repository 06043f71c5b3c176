"""qwen1.5-110b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B]

A copy of ``repro/configs/qwen1_5_110b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

QWEN15_110B = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
))
