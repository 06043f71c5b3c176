"""llama3.2-1b [dense] — small llama3. [hf:meta-llama/Llama-3.2-1B]

A copy of ``repro/configs/llama3_2_1b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

LLAMA32_1B = register(ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=64,
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
))
