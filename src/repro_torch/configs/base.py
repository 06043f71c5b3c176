"""Model / run configuration (a copy of ``repro/configs/base.py``).

One ``ModelConfig`` dataclass covers every architecture family of the
reference (dense, moe, vlm, audio, ssm, hybrid), so one config drives
both packages; the port so far runs ``family="dense"``.  ``reduced()``
gives the small variant tests instantiate.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Input shapes (assigned; see system brief)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
    # Bonus shape exercising the paper's verification (partial prefill):
    # gamma=4 pending-verify tokens + uncached accepted tokens (chunk of 32)
    # over a 32k cached prefix.
    "verify_32k": InputShape("verify_32k", 32_768, 128, "verify"),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Family selects the block layout.

    family:
      dense  -- decoder-only transformer (GQA, RoPE, optional qkv bias)
      moe    -- decoder-only with (possibly interleaved) MoE FFNs
      vlm    -- decoder-only with interleaved cross-attention image layers
      audio  -- encoder-decoder (whisper-like); conv/mel frontend stubbed
      ssm    -- attention-free Mamba2 (SSD)
      hybrid -- Mamba2 blocks + shared attention block every k layers
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""            # citation (hf model card / arXiv)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # 1 = every layer is MoE; 2 = alternate
    n_shared_experts: int = 0

    # --- VLM (cross-attention image layers) ---
    cross_attn_every: int = 0   # every k-th layer is cross-attn (0 = none)
    n_image_tokens: int = 1_601 # stub frontend output length
    vision_dim: int = 0         # frontend embedding dim (0 -> d_model)

    # --- audio (enc-dec) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1_500 # stub conv/mel frontend output length

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0          # 0 -> d_inner // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256        # SSD chunk length
    ssm_conv_width: int = 4

    # --- hybrid (zamba2-like) ---
    attn_every: int = 0         # shared attention block every k ssm layers

    # --- serving ---
    sliding_window: int = 8_192  # long-context decode window for attention archs
    max_verify_chunk: int = 32   # Sarathi-style partial-prefill chunk
    # KV cache layout: "dense" allocates (slots, s_max) up front; "paged"
    # backs slots with a shared block pool + per-slot block tables
    # (vLLM/PagedAttention layout) so memory scales with *actual* sequence
    # lengths and admission is bound by free blocks, not slot count.
    cache_impl: str = "dense"    # "dense" | "paged"
    kv_block_size: int = 16      # tokens per KV block when cache_impl="paged"
    # Paged Pallas kernel streaming (attn_impl="pallas" + cache_impl=
    # "paged"): each grid step fuses paged_block_kv // kv_block_size
    # consecutive block-table entries into one dense-sized DMA, and
    # paged_kv_splits > 1 adds flash-decode split-KV parallelism over
    # the sequence axis (partials merged by a jnp epilogue; =1 is
    # bit-identical to the single-pass kernel).
    paged_block_kv: int = 128    # fused KV tokens per paged grid step
    paged_kv_splits: int = 1     # parallel sequence splits (flash-decode)
    # Prefix sharing (paged only): dedupe identical leading full prompt
    # blocks across slots via ref-counted blocks; divergent writes into a
    # shared block fork a private copy (copy-on-write).
    share_prefix: bool = False
    # Prefix retention (implies share_prefix): released ref-0 prefix
    # blocks park on a cached-free LRU instead of returning to the free
    # list, so later sessions with the same prompt prefix re-adopt them
    # without recompute.  Reclaimed lazily under allocation pressure.
    retain_prefix: bool = False
    retain_blocks: int = 0       # cached-free LRU cap in blocks (0 = unbounded)
    # Host swap tier (paged only): preempted streams may be gathered to
    # host memory and scattered back instead of recompute-eviction when
    # the modeled D2H+H2D round trip beats the modeled re-prefill.
    kv_swap: bool = False
    host_swap_blocks: int = 0    # host store cap in blocks (0 = unbounded)
    # Content-addressed host store (kv_swap + share_prefix): host blocks
    # are keyed by prefix chain hash, deduped across streams, and new
    # sessions adopt matching host blocks via H2D scatter at admission.
    host_dedupe: bool = True
    # Eviction victim selection: "youngest" | "most-blocks" | "slo-aware"
    preempt_policy: str = "youngest"

    # --- implementation knobs (hillclimb levers) ---
    attn_impl: str = "blocked"   # "naive" | "blocked" (online-softmax scan)
    attn_block_kv: int = 1_024   # KV block for blocked attention
    remat: bool = True           # activation checkpointing on the layer scan
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.family in ("ssm", "hybrid") and self.ssm_heads == 0:
            d_inner = self.ssm_expand * self.d_model
            object.__setattr__(self, "ssm_heads", d_inner // self.ssm_head_dim)
        if self.family == "vlm" and self.vision_dim == 0:
            object.__setattr__(self, "vision_dim", self.d_model)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def gqa_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if n_heads else 0
        # keep the GQA character if the full config had it
        if n_heads and self.n_kv_heads < self.n_heads and n_kv == n_heads:
            n_kv = max(1, n_heads // 2)
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads if n_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1_024),
            sliding_window=256,
            attn_block_kv=128,
            ssm_head_dim=32,
            ssm_heads=0,
            ssm_chunk=32,
            remat=False,
            dtype="float32",
        )
        if self.n_experts:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["top_k"] = min(self.top_k, 2)
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
            kw["n_layers"] = 4  # 2 self + 2 cross rounds
            kw["n_image_tokens"] = 16
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
            kw["n_audio_frames"] = 24
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 4
        if self.family in ("ssm", "hybrid"):
            kw["ssm_state"] = min(self.ssm_state, 16)
        cfg = self.replace(**kw)
        return cfg

    # ------------------------------------------------------------------
    # Parameter counting (for roofline MODEL_FLOPS = 6 N D)
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, dff, V = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        if self.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        ffn = 3 * d * dff  # gated (SwiGLU)
        n = 0
        if self.family in ("dense", "moe", "vlm"):
            per_layer_norms = 2 * d
            for layer in range(self.n_layers):
                if self.family == "vlm" and self.cross_attn_every and (
                    (layer + 1) % self.cross_attn_every == 0
                ):
                    n += attn + ffn + per_layer_norms  # cross-attn layer
                    continue
                is_moe = (
                    self.family == "moe"
                    and self.n_experts
                    and (layer % self.moe_every == self.moe_every - 1)
                )
                if is_moe:
                    router = d * self.n_experts
                    experts = self.n_experts * 3 * d * dff
                    shared = self.n_shared_experts * 3 * d * dff
                    if active_only:
                        experts = self.top_k * 3 * d * dff
                    n += attn + router + experts + shared + per_layer_norms
                else:
                    dense_ff = ffn if self.family != "moe" else 3 * d * self.d_ff_dense
                    n += attn + dense_ff + per_layer_norms
        elif self.family == "audio":
            n += self.n_encoder_layers * (attn + ffn + 2 * d)
            n += self.n_layers * (2 * attn + ffn + 3 * d)  # self+cross
        elif self.family == "ssm":
            n += self.n_layers * (self._ssm_block_params() + d)
        elif self.family == "hybrid":
            n += self.n_layers * (self._ssm_block_params() + d)
            n_attn = self.n_layers // max(self.attn_every, 1)
            n += attn + ffn + 2 * d  # shared weights applied n_attn times
        n += V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        n += d  # final norm
        return n

    @property
    def d_ff_dense(self) -> int:
        # moe archs that interleave dense FFN layers use d_ff for experts
        # and this for the dense layers (same value unless overridden).
        return self.d_ff

    def _ssm_block_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_heads
        in_proj = d * (2 * di + 2 * st + nh)  # z, x, B, C, dt
        conv = self.ssm_conv_width * (di + 2 * st)
        out = di * d
        return in_proj + conv + out + 2 * nh + di  # A, D, gate norm

    # Active params (MoE-aware) for MODEL_FLOPS.
    def active_param_count(self) -> int:
        return self.param_count(active_only=True)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import side-effect: populate registry
    from repro_torch import configs as _c  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401

    return sorted(_REGISTRY)
