"""Shape-only stand-ins for every model input (port of
``repro/launch/specs.py``): ``meta`` tensors with the reference's shapes
and dtypes.  The dry run traces against these; they hold no data.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.models import model as M


def _meta(shape, dtype, device="meta"):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def input_shape(shape):
    """An ``INPUT_SHAPES`` entry by name, or the ``InputShape`` itself."""
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def aux_specs(cfg: ModelConfig, batch: int, device="meta") -> dict:
    dt = M.torch_dtype(cfg)
    aux = {}
    if cfg.family == "vlm":
        aux["image_embeds"] = _meta((batch, cfg.n_image_tokens,
                                     cfg.vision_dim), dt, device)
    if cfg.family == "audio":
        aux["audio_frames"] = _meta((batch, cfg.n_audio_frames,
                                     cfg.d_model), dt, device)
    return aux


def params_specs(cfg: ModelConfig) -> dict:
    return M.init_params(cfg, device="meta")


def cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                device="meta") -> dict:
    return M.init_cache(cfg, batch, s_max, device=device)


def cache_len_for(cfg: ModelConfig, shape) -> int:
    """Attention cache buffer length for a decode shape: the full context
    for decode_32k, the sliding window for long_500k (SSM archs carry
    O(1) state regardless)."""
    shp = input_shape(shape)
    if shp.name == "long_500k":
        return cfg.sliding_window
    return shp.seq_len


def decode_window_for(cfg: ModelConfig, shape) -> int:
    return cfg.sliding_window if input_shape(shape).name == "long_500k" else 0


def input_specs(cfg: ModelConfig, shape, device="meta") -> dict:
    """Everything a step function needs, as ``meta`` tensors (on another
    ``device``: an empty cache and uninitialised inputs to fill).

    train:   {batch: {tokens, [aux]}}
    prefill: {cache, tokens, aux}
    decode:  {cache, tokens (B,1), positions (B,1)}
    verify:  {cache, tokens (B,C), positions (B,C)}  (the paper's partial
             prefill)
    """
    shp = input_shape(shape)
    B, S = shp.global_batch, shp.seq_len
    i32 = torch.int32
    if shp.kind == "train":
        return {"batch": {"tokens": _meta((B, S), i32, device),
                          **aux_specs(cfg, B, device)}}
    if shp.kind == "prefill":
        return {"cache": cache_specs(cfg, B, S, device),
                "tokens": _meta((B, S), i32, device),
                "aux": aux_specs(cfg, B, device)}
    if shp.kind in ("decode", "verify"):
        T = 1 if shp.kind == "decode" else cfg.max_verify_chunk
        s_max = cache_len_for(cfg, shp) if shp.kind == "decode" else S
        return {"cache": cache_specs(cfg, B, s_max, device),
                "tokens": _meta((B, T), i32, device),
                "positions": _meta((B, T), i32, device)}
    raise ValueError(shp.kind)
