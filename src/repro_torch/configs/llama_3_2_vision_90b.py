"""llama-3.2-vision-90b [vlm] — cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

100 layers total: every 5th layer is a cross-attention layer over
precomputed vision-patch embeddings (frontend stubbed per assignment).

A copy of ``repro/configs/llama_3_2_vision_90b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

LLAMA32_VISION_90B = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,    # 20 cross-attn layers out of 100
    n_image_tokens=1601,
    vision_dim=7680,       # frontend projector input dim (stub)
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
