"""whisper-medium [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356]

24 encoder + 24 decoder layers.  The mel-spectrogram + conv feature
extractor is stubbed: ``input_specs`` provides precomputed frame
embeddings of shape (batch, n_audio_frames, d_model).

A copy of ``repro/configs/whisper_medium.py``.
"""
from repro_torch.configs.base import ModelConfig, register

WHISPER_MEDIUM = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,          # MHA (kv=16)
    d_ff=4096,
    vocab=51865,
    rope_theta=10_000.0,    # we use RoPE in place of learned positions
    n_audio_frames=1500,
    source="arXiv:2212.04356",
))
