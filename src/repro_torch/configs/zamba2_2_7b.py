"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks. [arXiv:2411.15242]

A copy of ``repro/configs/zamba2_2_7b.py``.

54 mamba2 layers; one weight-shared attention+FFN block is applied every
6 mamba layers (9 applications of the same parameters).
"""
from repro_torch.configs.base import ModelConfig, register

ZAMBA2_2_7B = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,          # shared attn block is MHA
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
    rope_theta=10_000.0,
    source="arXiv:2411.15242",
))
