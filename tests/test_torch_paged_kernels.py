"""Port paged kernels against the reference, on the CPU.

The port's paged decode, paged partial prefill and ``combine_splits``
(their plain PyTorch versions: the wrappers take them for CPU tensors)
are held against the reference in two ways on the same numpy-seeded
inputs:

* the reference's ``decode_attention_ref`` / ``partial_prefill_ref`` over
  the gathered ``paged_kv_view`` of the pool;
* the reference's paged Pallas kernels in interpret mode.  Under the
  installed jax those kernels ask for ``pltpu.TPUCompilerParams``, which
  jax renamed ``CompilerParams``; the alias is set only through pytest's
  ``monkeypatch`` (undone after each test), so the reference's own paged
  tests see jax exactly as they would without this file.

Parameter sets and tolerances are ``tests/test_kernels.py``'s.  The CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import paged as RPG
from repro.kernels.decode_gqa.decode_gqa import (
    decode_attention_paged as ref_decode_paged)
from repro.kernels.decode_gqa.ref import decode_attention_ref
from repro.kernels.partial_prefill.partial_prefill import (
    partial_prefill_attention_paged as ref_prefill_paged)
from repro.kernels.partial_prefill.ref import partial_prefill_ref
from repro.models import layers as RL
from repro_torch.kernels import decode_gqa, partial_prefill
from repro_torch.kernels import paged as PG

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (block_kv, kv_splits): one-block steps, fused steps, fused + split-KV
PAGED_VARIANTS = [(None, 1), (128, 1), (64, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_paged(monkeypatch):
    """Let the reference's paged Pallas kernels run in interpret mode
    under this jax, for the duration of one test only."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(x, dtype):
    """numpy f32 -> (jax array, torch tensor) with identical ``dtype``
    values."""
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def _random_paged_cache(rng, B, nb, bs, mbps, nkv, hd, lens):
    """A pool with ragged per-slot fills: tables map a random permutation
    of pool blocks, unmapped tails stay -1 (``test_kernels.py``'s
    layout).  Returns numpy arrays."""
    kp = rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32)
    pos = np.full((nb, bs), -1, np.int32)
    bt = np.full((B, mbps), -1, np.int32)
    free = list(rng.permutation(nb))
    for b, L in enumerate(lens):
        for j in range(-(-L // bs)):
            blk = free.pop()
            bt[b, j] = blk
            valid = min(bs, L - j * bs)
            pos[blk, :valid] = j * bs + np.arange(valid)
    return kp, vp, pos, bt


def _gathered(kp, vp, pos, bt, dtype):
    """The reference's gathered (B, s_max) view of the pool."""
    k, v, p = RL.paged_kv_view({"k": jnp.asarray(kp, JNP[dtype]),
                                "v": jnp.asarray(vp, JNP[dtype]),
                                "pos": jnp.asarray(pos),
                                "block_tables": jnp.asarray(bt)})
    return k, v, p


@pytest.mark.parametrize("B,nb,bs,mbps,nh,nkv,hd,window", [
    (3, 24, 8, 6, 4, 2, 32, 0),
    (2, 12, 16, 4, 8, 8, 64, 0),
    (2, 40, 8, 8, 4, 1, 16, 24),    # MQA + sliding window
    (2, 16, 8, 6, 4, 4, 80, 0),     # hd 80 (zamba2's width), MHA
])
@pytest.mark.parametrize("blkv,splits", PAGED_VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_paged_matches_reference(pallas_paged, B, nb, bs, mbps, nh,
                                        nkv, hd, window, blkv, splits, dtype):
    rng = np.random.default_rng(11)
    lens = [int(rng.integers(2, mbps * bs)) for _ in range(B)]
    kp, vp, pos, bt = _random_paged_cache(rng, B, nb, bs, mbps, nkv, hd,
                                          lens)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    qp = np.asarray([L - 1 for L in lens], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, kp, vp))
    before = decode_gqa.paged_launches
    got = decode_gqa.decode_attention_paged(
        qt, kt, vt, torch.from_numpy(qp), torch.from_numpy(pos),
        torch.from_numpy(bt), window=window, block_kv=blkv,
        kv_splits=splits)
    assert decode_gqa.paged_launches == before    # plain version: no launch
    assert got.dtype == TORCH[dtype] and got.shape == (B, nh, hd)
    kd, vd, posd = _gathered(kp, vp, pos, bt, dtype)
    want_view = decode_attention_ref(qj, kd, vd, jnp.asarray(qp), posd,
                                     window=window)
    want_pallas = ref_decode_paged(qj, kj, vj, jnp.asarray(qp),
                                   jnp.asarray(pos), jnp.asarray(bt),
                                   window=window, block_kv=blkv,
                                   kv_splits=splits)
    np.testing.assert_allclose(_np(got), _np(want_view), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want_pallas), **TOL[dtype])


@pytest.mark.parametrize("B,C,nb,bs,mbps,nh,nkv,hd,window", [
    (2, 8, 24, 8, 6, 4, 2, 32, 0),
    (1, 16, 12, 16, 4, 8, 8, 64, 0),
    (2, 4, 40, 8, 8, 4, 1, 16, 24),
    (2, 8, 16, 8, 6, 4, 4, 80, 0),  # hd 80 (zamba2's width), MHA
])
@pytest.mark.parametrize("blkv,splits", PAGED_VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_prefill_paged_matches_reference(pallas_paged, B, C, nb, bs,
                                                 mbps, nh, nkv, hd, window,
                                                 blkv, splits, dtype):
    rng = np.random.default_rng(13)
    lens = [int(rng.integers(C + 1, mbps * bs)) for _ in range(B)]
    kp, vp, pos, bt = _random_paged_cache(rng, B, nb, bs, mbps, nkv, hd,
                                          lens)
    q = rng.standard_normal((B, C, nh, hd)).astype(np.float32)
    # chunk queries are the tail of each slot's sequence (already in the
    # pool: write-then-attend), ragged via -1 padding
    qp = np.full((B, C), -1, np.int32)
    for b in range(B):
        nq = int(rng.integers(1, C + 1))
        qp[b, :nq] = lens[b] - nq + np.arange(nq)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, kp, vp))
    before = partial_prefill.paged_launches
    got = partial_prefill.partial_prefill_attention_paged(
        qt, kt, vt, torch.from_numpy(qp), torch.from_numpy(pos),
        torch.from_numpy(bt), window=window, block_kv=blkv,
        kv_splits=splits)
    assert partial_prefill.paged_launches == before
    assert got.dtype == TORCH[dtype] and got.shape == (B, C, nh, hd)
    # padded query rows come out exactly 0, never NaN
    assert (_np(got)[qp < 0] == 0).all()
    kd, vd, posd = _gathered(kp, vp, pos, bt, dtype)
    want_view = partial_prefill_ref(qj, kd, vd, jnp.asarray(qp), posd,
                                    window=window)
    want_pallas = ref_prefill_paged(qj, kj, vj, jnp.asarray(qp),
                                    jnp.asarray(pos), jnp.asarray(bt),
                                    window=window, block_kv=blkv,
                                    kv_splits=splits)
    mask = (qp >= 0)[:, :, None, None]
    np.testing.assert_allclose(_np(got) * mask, _np(want_view) * mask,
                               **TOL[dtype])
    np.testing.assert_allclose(_np(got) * mask, _np(want_pallas) * mask,
                               **TOL[dtype])


@pytest.mark.parametrize("kind", ["decode", "partial_prefill"])
def test_paged_split_kv_agrees(kind):
    """kv_splits in {1, 2, 4} agree with each other up to f32 rounding of
    the merge, and with the gathered-view oracle (the reference's
    ``test_paged_split_kv_degenerates`` inputs)."""
    rng = np.random.default_rng(17)
    B, nb, bs, mbps, nh, nkv, hd, C = 2, 24, 8, 6, 4, 2, 32, 8
    lens = [int(rng.integers(C + 1, mbps * bs)) for _ in range(B)]
    kp, vp, pos, bt = _random_paged_cache(rng, B, nb, bs, mbps, nkv, hd,
                                          lens)
    kd, vd, posd = _gathered(kp, vp, pos, bt, "float32")
    t = {n: torch.from_numpy(x) for n, x in
         dict(k=kp, v=vp, pos=pos, bt=bt).items()}
    if kind == "decode":
        q = rng.standard_normal((B, nh, hd)).astype(np.float32)
        qp = np.asarray([L - 1 for L in lens], np.int32)
        fn = decode_gqa.decode_attention_paged
        oracle = decode_attention_ref(jnp.asarray(q), kd, vd,
                                      jnp.asarray(qp), posd)
    else:
        q = rng.standard_normal((B, C, nh, hd)).astype(np.float32)
        qp = np.stack([lens[b] - C + np.arange(C)
                       for b in range(B)]).astype(np.int32)
        fn = partial_prefill.partial_prefill_attention_paged
        oracle = partial_prefill_ref(jnp.asarray(q), kd, vd,
                                     jnp.asarray(qp), posd)

    def run(splits):
        return fn(torch.from_numpy(q), t["k"], t["v"], torch.from_numpy(qp),
                  t["pos"], t["bt"], kv_splits=splits)

    base = run(1)
    for sp in (2, 4):
        np.testing.assert_allclose(_np(run(sp)), _np(base), atol=2e-6,
                                   rtol=2e-6)
    np.testing.assert_allclose(_np(base), _np(oracle), **TOL["float32"])


def test_combine_splits_matches_reference():
    """The plain merge equals the reference's ``combine_splits`` on
    partials with empty splits (NEG_INF, 0, 0) and an all-empty row, and
    at one split it is bit-identical to finishing acc / l in place."""
    rng = np.random.default_rng(19)
    N, S, R, hd = 3, 4, 5, 16
    m = rng.standard_normal((N, S, R)).astype(np.float32) * 3
    l = rng.uniform(0.5, 4.0, (N, S, R)).astype(np.float32)
    acc = rng.standard_normal((N, S, R, hd)).astype(np.float32)
    m[0, 1], l[0, 1], acc[0, 1] = PG.NEG_INF, 0.0, 0.0   # empty split
    m[1, :, 2], l[1, :, 2], acc[1, :, 2] = PG.NEG_INF, 0.0, 0.0  # empty row
    got = PG.combine_splits(*map(torch.from_numpy, (m, l, acc)),
                            torch.float32)
    want = RPG.combine_splits(*map(jnp.asarray, (m, l, acc)), jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    assert (_np(got)[1, 2] == 0).all()
    one = PG.combine_splits(*(torch.from_numpy(x[:, :1]) for x in
                              (m, l, acc)), torch.float32)
    l1 = torch.from_numpy(l[:, 0])
    finish = torch.from_numpy(acc[:, 0]) / torch.where(
        l1 == 0.0, 1.0, l1)[..., None]
    assert torch.equal(one, finish)


@pytest.mark.parametrize("max_bps,bs,block_kv,kv_splits", [
    (6, 8, None, 1), (6, 8, 128, 1), (6, 8, 64, 4), (128, 16, 128, 1),
    (128, 16, 128, 4), (128, 16, None, 1), (5, 4, 8, 4), (16, 16, 64, 3),
])
def test_fused_layout_matches_reference(max_bps, bs, block_kv, kv_splits):
    """The split ranges the CUDA kernels walk come from the reference's
    own grid arithmetic."""
    assert PG.fused_layout(max_bps, bs, block_kv, kv_splits) == \
        RPG.fused_layout(max_bps, bs, block_kv, kv_splits)
    assert PG.paged_grid_info(max_bps, bs, block_kv, kv_splits) == \
        RPG.paged_grid_info(max_bps, bs, block_kv, kv_splits)


def test_paged_idle_slot_is_zero():
    """A slot with an all-unmapped table, or a padded query (q_pos = -1),
    gives 0 -- the pool's last block is never read through a -1 entry."""
    rng = np.random.default_rng(23)
    nb, bs, nkv, hd = 4, 4, 2, 16
    k = torch.from_numpy(rng.standard_normal((nb, bs, nkv, hd))
                         .astype(np.float32))
    pos = torch.arange(nb * bs, dtype=torch.int32).reshape(nb, bs)
    bt = torch.full((2, 3), -1, dtype=torch.int32)
    bt[1, 0] = 0
    q = torch.from_numpy(rng.standard_normal((2, 4, hd)).astype(np.float32))
    out = decode_gqa.decode_attention_paged(
        q, k, k, torch.tensor([20, 3], dtype=torch.int32), pos, bt)
    assert (out[0] == 0).all() and (out[1] != 0).any()
    out = partial_prefill.partial_prefill_attention_paged(
        q[:, None], k, k, torch.tensor([[3], [-1]], dtype=torch.int32), pos,
        bt)
    assert (out == 0).all()
