"""Port kernels against the reference Pallas kernels.

The same numpy-seeded inputs go through the reference Pallas kernel (in
interpret mode on the CPU, as ``tests/test_kernels.py`` runs it) and the
port's wrapper, which on CPU tensors takes the kernel's plain PyTorch
version.  Parameter sets and tolerances are those of
``tests/test_kernels.py``.  The CUDA kernels themselves are held against
the same plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.attn_importance.attn_importance import (
    attn_with_importance as ref_attn_with_importance)
from repro.kernels.decode_gqa.decode_gqa import (
    decode_attention as ref_decode_attention)
from repro.kernels.partial_prefill.partial_prefill import (
    partial_prefill_attention as ref_partial_prefill)
from repro_torch.kernels import attn_importance, decode_gqa, on_cpu
from repro_torch.kernels import partial_prefill

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, dtype):
    """One normal draw as (jax array, torch tensor) with identical values
    in ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,T,S,nh,nkv,hd,causal", [
    (2, 64, 64, 4, 2, 32, True),
    (1, 100, 100, 8, 8, 64, True),      # non-divisible T (padding)
    (2, 32, 32, 4, 4, 16, False),
    (1, 16, 16, 8, 1, 32, True),        # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_importance_matches_pallas(B, T, S, nh, nkv, hd, causal, dtype):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (B, T, nh, hd), dtype)
    kj, kt = _pair(rng, (B, S, nkv, hd), dtype)
    vj, vt = _pair(rng, (B, S, nkv, hd), dtype)
    qp = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    kp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    o1, i1 = ref_attn_with_importance(qj, kj, vj, jnp.asarray(qp),
                                      jnp.asarray(kp), causal=causal,
                                      block_q=32)
    before = attn_importance.launches
    o2, i2 = attn_importance.attn_with_importance(
        qt, kt, vt, torch.from_numpy(qp), torch.from_numpy(kp),
        causal=causal)
    assert attn_importance.launches == before   # plain version: no launch
    assert o2.dtype == TORCH[dtype] and i2.dtype == torch.float32
    np.testing.assert_allclose(_np(o2), _np(o1), **TOL[dtype])
    np.testing.assert_allclose(_np(i2), _np(i1), atol=1e-3)
    # column sums of the softmax matrix sum to Tq per head
    np.testing.assert_allclose(_np(i2).sum(-1), np.full((B, nh), float(T)),
                               rtol=1e-3)


def _cache_positions(rng, B, S, C):
    qp = np.zeros((B, C), np.int32)
    kp = np.full((B, S), -1, np.int32)
    for b in range(B):
        L = int(rng.integers(C + 1, S - C))
        kp[b, :L] = np.arange(L)
        nq = int(rng.integers(1, C + 1))
        qp[b, :nq] = L + np.arange(nq)
        qp[b, nq:] = -1
        kp[b, L:L + nq] = L + np.arange(nq)  # write-then-attend semantics
    return qp, kp


@pytest.mark.parametrize("B,C,S,nh,nkv,hd,window", [
    (2, 8, 128, 4, 2, 32, 0),
    (1, 32, 100, 8, 8, 64, 0),
    (2, 4, 256, 4, 1, 16, 64),
    (3, 16, 96, 6, 3, 32, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_prefill_matches_pallas(B, C, S, nh, nkv, hd, window, dtype):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (B, C, nh, hd), dtype)
    kj, kt = _pair(rng, (B, S, nkv, hd), dtype)
    vj, vt = _pair(rng, (B, S, nkv, hd), dtype)
    qp, kp = _cache_positions(rng, B, S, C)
    o1 = ref_partial_prefill(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kp),
                             window=window, block_kv=64)
    before = partial_prefill.launches
    o2 = partial_prefill.partial_prefill_attention(
        qt, kt, vt, torch.from_numpy(qp), torch.from_numpy(kp),
        window=window)
    assert partial_prefill.launches == before
    assert o2.dtype == TORCH[dtype] and o2.shape == (B, C, nh, hd)
    mask = (qp >= 0)[:, :, None, None]
    np.testing.assert_allclose(_np(o2) * mask, _np(o1) * mask, **TOL[dtype])
    # padded query rows come out exactly 0, never NaN
    assert (_np(o2)[qp < 0] == 0).all()


@pytest.mark.parametrize("B,S,nh,nkv,hd,window", [
    (2, 128, 8, 2, 32, 0),
    (1, 300, 4, 4, 64, 0),     # non-divisible S
    (3, 256, 8, 1, 16, 64),    # MQA + sliding window
    (2, 64, 16, 4, 32, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_gqa_matches_pallas(B, S, nh, nkv, hd, window, dtype):
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, (B, nh, hd), dtype)
    kj, kt = _pair(rng, (B, S, nkv, hd), dtype)
    vj, vt = _pair(rng, (B, S, nkv, hd), dtype)
    kp = np.full((B, S), -1, np.int32)
    qp = np.zeros(B, np.int32)
    for b in range(B):
        L = int(rng.integers(5, S))
        kp[b, :L] = np.arange(L)
        qp[b] = L - 1
    o1 = ref_decode_attention(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kp),
                              window=window, block_kv=64)
    before = decode_gqa.launches
    o2 = decode_gqa.decode_attention(qt, kt, vt, torch.from_numpy(qp),
                                     torch.from_numpy(kp), window=window)
    assert decode_gqa.launches == before
    assert o2.dtype == TORCH[dtype] and o2.shape == (B, nh, hd)
    np.testing.assert_allclose(_np(o2), _np(o1), **TOL[dtype])


def test_decode_idle_slot_is_zero():
    """A slot with no valid key (an idle decode slot, q_pos = -1) gives
    0, as the Pallas kernel's l == 0 guard does -- not the uniform average
    the unguarded softmax would."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 16)).astype(np.float32))
    qp = torch.tensor([-1, 5], dtype=torch.int32)
    kp = torch.full((2, 32), -1, dtype=torch.int32)
    kp[1, :6] = torch.arange(6)
    out = decode_gqa.decode_attention(q, k, k, qp, kp)
    assert (out[0] == 0).all() and torch.isfinite(out).all()
    assert (out[1] != 0).any()


def test_wrappers_refuse_mixed_and_foreign_devices():
    cpu = torch.zeros(2)
    assert on_cpu(cpu, cpu)
    with pytest.raises(ValueError):
        on_cpu(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        on_cpu(torch.zeros(2, device="meta"))
