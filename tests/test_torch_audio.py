"""Port of the audio family against the reference, on the CPU.

``whisper-medium`` is a copy of the reference's config file.  Its
reduced model (two non-causal encoder layers over stub audio frames, two
decoder layers with causal self-attention and cross-attention over the
encoder's output) runs through both packages in float32 with the
reference's own weights (through ``repro_torch.bridge``) under
``attn_impl="blocked"`` and ``"pallas"`` (the reference's Pallas kernels
in interpret mode, the port's wrappers on their plain versions): the
forward with audio frames, a prefill with them then decode steps and a
verify chunk over the cross cache the prefill wrote.  The tiny pair's
LLM made audio is served by both packages' dense engines (whose steps
never fill the cross cache, as the reference serves the family): the
``run_cloud_centric`` streams must be identical.  The checks are
``tests/test_torch_vlm.py``'s.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import model as TM
from test_torch_vlm import (B, EXTRA, MODEL_TOL, T, aux_array, build_model,
                            check_bridge_bf16, check_engine_streams,
                            check_forward, check_layouts, check_prefill_decode,
                            check_refusals, check_reset_slot_and_kv_bytes,
                            check_verify_chunk, reference_engine_run)

NAME = "whisper-medium"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def audio_model():
    return build_model(NAME)


@pytest.fixture(scope="module")
def audio_engine():
    return reference_engine_run("audio")


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_forward_matches_reference(audio_model, impl):
    check_forward(audio_model, impl)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_prefill_decode_matches_reference(audio_model, impl):
    check_prefill_decode(audio_model, impl)


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_verify_chunk_matches_reference(audio_model, impl):
    check_verify_chunk(audio_model, impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_match_reference_layout(dtype):
    params = check_layouts(NAME, dtype)
    assert "bq" not in params["dec_layers"]["self_attn"]
    assert "bq" not in params["dec_layers"]["cross_attn"]


def test_bridge_keeps_every_leaf():
    check_bridge_bf16(NAME)


def test_paged_cache_and_missing_inputs_refused():
    check_refusals(NAME)


def test_encoder_feeds_every_cross_cache(audio_model):
    """A prefill with frames writes, into decoder layer i's cross cache,
    the encoder's output (run once) through that layer's own K/V
    projections; other frames change the logits."""
    m = audio_model
    tcfg, tp = m["tcfg"], m["tp"]
    frames = torch.from_numpy(m["aux"])
    cache = TM.init_cache(tcfg, B, T + EXTRA, device="cpu")
    TM.forward(tcfg, tp, torch.from_numpy(m["toks"][:, :T]),
               torch.from_numpy(m["pos"][:, :T]), cache=cache,
               aux_inputs={"audio_frames": frames})
    enc = TM._audio_encoder(tcfg, tp, frames)
    nkv, hd = tcfg.n_kv_heads, tcfg.head_dim
    for i in range(tcfg.n_layers):
        ca = TM.layer_slice(tp["dec_layers"], i)["cross_attn"]
        for key, w in (("k", "wk"), ("v", "wv")):
            want = (enc @ ca[w]).reshape(B, tcfg.n_audio_frames, nkv, hd)
            np.testing.assert_allclose(cache["cross"][key][i].numpy(),
                                       want.numpy(), **MODEL_TOL)
    assert not torch.allclose(cache["cross"]["k"][0], cache["cross"]["k"][1])
    toks, pos = torch.from_numpy(m["toks"]), torch.from_numpy(m["pos"])
    lg = [TM.forward(tcfg, tp, toks, pos,
                     aux_inputs={"audio_frames": torch.from_numpy(
                         aux_array(tcfg, B, s))})[0] for s in (1, 2)]
    assert float((lg[0] - lg[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_engine_streams_identical(audio_engine, impl):
    check_engine_streams(audio_engine, "audio", impl)


def test_reset_slot_and_kv_bytes_walk_self_and_cross(audio_engine):
    check_reset_slot_and_kv_bytes(audio_engine, "audio")
