"""The paper's own evaluation models (Table 3), a copy of
``repro/configs/synera_pair.py``.  The port serves the full-size pair on
one GPU (``chip_smoke.py``); the parity tests run the tiny variants on
the CPU against the reference.

SLM: llama-160m-like   [hf:JackFram/llama-160m]  (paper's Llama-160M draft)
LLM: llama-7b-like     [hf:meta-llama/Llama-2-7b] (paper's cloud verifier)
"""
from repro_torch.configs.base import ModelConfig, register

SYNERA_SLM = register(ModelConfig(
    name="synera-slm-160m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=32000,
    rope_theta=10_000.0,
    source="hf:JackFram/llama-160m (paper Table 3)",
))

SYNERA_LLM = register(ModelConfig(
    name="synera-llm-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=32000,
    rope_theta=10_000.0,
    source="hf:meta-llama/Llama-2-7b (paper Table 3)",
))


def tiny_pair(vocab: int = 512):
    """Trainable SLM/LLM pair for CPU end-to-end experiments.

    The LLM is strictly deeper/wider so that, after training on the same
    synthetic corpus, it is measurably better — reproducing the paper's
    SLM/LLM capability gap at small scale.
    """
    slm = ModelConfig(
        name="tiny-slm", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=vocab,
        rope_theta=10_000.0, remat=False, dtype="float32",
    )
    llm = ModelConfig(
        name="tiny-llm", family="dense", n_layers=6, d_model=256,
        n_heads=8, n_kv_heads=8, d_ff=512, vocab=vocab,
        rope_theta=10_000.0, remat=False, dtype="float32",
    )
    return slm, llm
