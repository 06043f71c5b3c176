"""mamba2-2.7b [ssm] -- SSD (state-space duality), attention-free; a copy
of ``repro/configs/mamba2_2_7b.py``.
[arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, register

MAMBA2_2_7B = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    source="arXiv:2405.21060",
))
