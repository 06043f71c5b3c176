"""Port paged KV cache against the reference, on the CPU.

Layers covered, each on the same numpy-seeded inputs in both packages:

* the in-place cache walkers (``cache_write_paged``, block copies, tail
  row copies, peek / gather / scatter, the gathered view) against the
  reference's functional ones, with -1 padding and a pair list whose
  destination is another pair's source;
* ``BlockAllocator`` units (the reference's own allocator tests, run on
  the port's copy);
* engine steps and greedy token streams of the tiny pair with the
  reference's weights bridged in: the port's paged engine (``pallas``
  through the kernels' plain versions, and ``blocked``) against the
  reference's dense and paged engines -- plain paged, shared prefix with
  a forced copy-on-write, retention over two waves, swapping under a
  pool small enough to preempt, and host dedupe with adopt-from-host --
  with equal ``pool_stats`` counters;
* the reference's paged-pool deadlock (ROADMAP queue 3, R2), which the
  port reproduces exactly.

Each engine is built once per test or module fixture (the reference jits
its steps per engine).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.synera_pair import tiny_pair
from repro.core.offload import OffloadPolicy as RefPolicy
from repro.models import layers as RL
from repro.models import model as JM
from repro.serving import synergy as RSY
from repro.serving.device import DeviceRuntime as RefDevice
from repro.serving.engine import CloudEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.core.offload import OffloadPolicy
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving import synergy as SY
from repro_torch.serving.device import DeviceRuntime
from repro_torch.serving.engine import (BlockAllocator, BlockPoolExhausted,
                                        CloudEngine)

S_MAX = 256
# pool_stats fields that must agree number for number (kv_cache_bytes
# differs by design: the reference replicates the block table per layer)
POOL_FIELDS = ("free_blocks", "cached_free_blocks", "used_blocks",
               "peak_used_blocks", "n_blocks", "shared_blocks",
               "dedupe_hit_blocks", "cow_copies", "revived_blocks",
               "reclaimed_blocks", "tail_shared_tokens", "swapped_blocks",
               "swap_out_bytes", "swap_in_bytes", "host_store_blocks",
               "host_lru_blocks", "host_dedupe_hits", "host_adopted_blocks",
               "adopt_in_bytes", "demoted_blocks", "kv_bytes_peak")
SCHED_FIELDS = ("iterations", "prefill_iterations", "verify_iterations",
                "preemptions", "preempted_refed_tokens", "swap_evictions",
                "recompute_evictions", "swap_expirations", "admission_swaps")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Layers: in-place walkers against the reference's functional ones
# ---------------------------------------------------------------------------

def _stack(rng, n=2, nb=6, bs=4, nkv=2, hd=8):
    """A random paged kv stack (layers, nb, bs, ...) as (numpy dict,
    torch dict) with identical values."""
    st = {"k": _rand(rng, n, nb, bs, nkv, hd), "v": _rand(rng, n, nb, bs,
                                                          nkv, hd),
          "pos": rng.integers(-1, 40, (n, nb, bs)).astype(np.int32)}
    return st, {k: torch.from_numpy(v.copy()) for k, v in st.items()}


def _assert_stack_equal(got, want):
    for key in ("k", "v", "pos"):
        assert np.array_equal(_np(got[key]), np.asarray(want[key])), key


def test_cache_write_paged_matches_reference():
    """Padding (-1 positions) and tokens whose table entry is unmapped
    write nothing; a circular position wraps by s_max = max_bps * bs."""
    rng = np.random.default_rng(1)
    nb, bs, nkv, hd, B, T = 6, 4, 2, 8, 2, 5
    cache = {"k": _rand(rng, nb, bs, nkv, hd), "v": _rand(rng, nb, bs, nkv,
                                                          hd),
             "pos": np.full((nb, bs), -1, np.int32),
             "block_tables": np.array([[2, 5, -1], [0, -1, 4]], np.int32)}
    pos = np.array([[3, 4, 5, -1, 13], [1, 2, 5, 9, -1]], np.int32)
    kn, vn = _rand(rng, B, T, nkv, hd), _rand(rng, B, T, nkv, hd)
    want = RL.cache_write_paged({k: jnp.asarray(v) for k, v in
                                 cache.items()}, jnp.asarray(kn),
                                jnp.asarray(vn), jnp.asarray(pos))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got = L.cache_write_paged(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                              torch.from_numpy(pos))
    assert got is tc                                 # in place
    _assert_stack_equal(got, want)
    kg, vg, pg = L.paged_kv_view(got)
    kw, vw, pw = RL.paged_kv_view(want)
    for a, b in ((kg, kw), (vg, vw), (pg, pw)):
        assert np.array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("src,dst", [
    ([1, 2, -1], [2, 3, -1]),         # pair 1 reads pair 0's destination
    ([4, 0, 5], [0, 4, -1]),          # a swap of two blocks + a pad
])
def test_cache_copy_blocks_reads_old_pool(src, dst):
    rng = np.random.default_rng(2)
    st, tst = _stack(rng)
    want = RL.cache_copy_blocks({k: jnp.asarray(v) for k, v in st.items()},
                                jnp.asarray(src, jnp.int32),
                                jnp.asarray(dst, jnp.int32))
    _assert_stack_equal(L.cache_copy_blocks(tst, src, dst), want)


def test_cache_copy_block_rows_reads_old_pool():
    rng = np.random.default_rng(3)
    st, tst = _stack(rng)
    src, dst, rows = [1, 2, 3, -1], [2, 5, 0, -1], [3, 2, 0, 0]
    want = RL.cache_copy_block_rows(
        {k: jnp.asarray(v) for k, v in st.items()},
        *(jnp.asarray(x, jnp.int32) for x in (src, dst, rows)))
    _assert_stack_equal(L.cache_copy_block_rows(tst, src, dst, rows), want)


def test_cache_peek_gather_scatter_match_reference():
    rng = np.random.default_rng(4)
    st, tst = _stack(rng)
    blocks = [3, 0, -1]
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    peek = L.cache_peek_blocks(tst, blocks)
    want_peek = RL.cache_peek_blocks(jst, jnp.asarray(blocks, jnp.int32))
    _assert_stack_equal(peek, want_peek)
    # the peek is a copy: writing the pool afterwards leaves it intact
    tst["k"][:, 3] = 0
    assert np.array_equal(_np(peek["k"]), np.asarray(want_peek["k"]))
    tst["k"][:, 3] = torch.from_numpy(st["k"][:, 3])
    payload, got = L.cache_gather_blocks(tst, blocks)
    want_pay, want = RL.cache_gather_blocks(jst, jnp.asarray(blocks,
                                                             jnp.int32))
    _assert_stack_equal(payload, want_pay)
    _assert_stack_equal(got, want)
    dst = [5, -1, 1]
    got = L.cache_scatter_blocks(got, dst, payload)
    want = RL.cache_scatter_blocks(want, jnp.asarray(dst, jnp.int32),
                                   want_pay)
    _assert_stack_equal(got, want)


def test_paged_init_cache_guards():
    slm, _ = port_tiny_pair(vocab=64)
    with pytest.raises(ValueError):
        M.init_cache(slm, 2, 100, cache_impl="paged", block_size=16,
                     device="cpu")
    with pytest.raises(ValueError):
        M.init_cache(slm.replace(family="ssm", ssm_state=16), 2, 256,
                     cache_impl="paged", device="cpu")
    # the moe family pages each of its kv stacks, every stack with its
    # own block table
    moe = M.init_cache(slm.replace(family="moe", moe_every=2, n_experts=4),
                       2, 64, cache_impl="paged", block_size=16,
                       pool_blocks=5, device="cpu")
    assert set(moe) == {"dense", "moe"}
    for st in moe.values():
        assert st["k"].shape == (slm.n_layers // 2, 5, 16, slm.n_kv_heads,
                                 slm.head_dim)
        assert st["block_tables"].shape == (2, 4)
    assert moe["dense"]["block_tables"] is not moe["moe"]["block_tables"]
    assert [id(st) for st in M.paged_stacks(moe)] == [id(moe["dense"]),
                                                       id(moe["moe"])]
    c = M.init_cache(slm, 2, 64, cache_impl="paged", block_size=16,
                     pool_blocks=5, device="cpu")["layers"]
    assert c["k"].shape == (slm.n_layers, 5, 16, slm.n_kv_heads,
                            slm.head_dim)
    assert c["block_tables"].shape == (2, 4)
    assert (c["pos"] == -1).all() and (c["block_tables"] == -1).all()


# ---------------------------------------------------------------------------
# BlockAllocator units (tests/test_paged_cache.py, test_prefix_sharing.py
# and test_prefix_cache.py, on the port's allocator)
# ---------------------------------------------------------------------------

def test_allocator_mechanics():
    a = BlockAllocator(n_blocks=6, block_size=4, max_slots=3,
                       max_blocks_per_slot=4)
    assert a.blocks_for(1) == 1 and a.blocks_for(4) == 1
    assert a.blocks_for(5) == 2
    assert a.blocks_for(10_000) == 4          # capped at max_bps (window)
    assert a.extend(0, 7)                     # 2 blocks
    assert a.extend(1, 9)                     # 3 blocks
    assert a.free_blocks == 1 and a.used_blocks == 5
    # all-or-nothing: 2 more blocks for slot 0 cannot be met, no change
    assert not a.extend(0, 16)
    assert a.free_blocks == 1 and a.n_blocks_of[0] == 2
    assert a.extend(0, 8) and a.n_blocks_of[0] == 2
    freed = a.release(1)
    assert len(freed) == 3 and a.free_blocks == 4
    assert (a.table[1] == -1).all()
    assert a.peak_used == 5
    # FIFO recycling: freed blocks come back after the original tail
    assert a.extend(2, 16)
    order = list(a.table[2][a.table[2] >= 0])
    assert order[-len(freed):] == list(freed)


def test_allocator_match_adopt_refcounts():
    a = BlockAllocator(8, 4, 4, 8, share_prefix=True)
    toks = list(range(1, 13))                   # 12 tokens = 3 full blocks
    assert a.match_prefix(toks) == []
    assert a.extend(0, 12)
    a.register_prefix(0, toks)
    m = a.match_prefix(toks)                    # len-1 cap: 2 of 3
    assert m == [int(a.table[0, j]) for j in range(2)]
    assert len(a.match_prefix(toks + [50, 51])) == 3
    assert len(a.match_prefix(toks[:4] + [0] * 8)) == 1
    a.adopt_prefix(1, m)
    assert int(a.n_blocks_of[1]) == 2
    assert all(int(a.ref[b]) == 2 for b in m)
    assert a.used_blocks == 3 and a.shared_blocks == 2
    assert a.dedupe_hit_blocks == 2


def test_allocator_release_to_zero_frees_and_unregisters():
    a = BlockAllocator(8, 4, 4, 8, share_prefix=True)
    toks = list(range(1, 13))
    a.extend(0, 12)
    a.register_prefix(0, toks)
    a.adopt_prefix(1, a.match_prefix(toks))
    freed = a.release(1)
    assert len(freed) == 0 and a.used_blocks == 3
    assert all(int(r) in (0, 1) for r in a.ref)
    freed = a.release(0)
    assert len(freed) == 3 and a.used_blocks == 0
    assert a.match_prefix(toks) == []


def test_allocator_cow_fork_and_divergence_unregister():
    a = BlockAllocator(8, 4, 4, 8, share_prefix=True)
    toks = list(range(1, 13))
    a.extend(0, 12)
    a.register_prefix(0, toks)
    assert a.prepare_writes(0, [0, 1, 2]) == []   # realizes fill-pending
    assert a.match_prefix(toks + [9]) != []
    m = a.match_prefix(toks)
    a.adopt_prefix(1, m)
    src = m[1]
    pairs = a.prepare_writes(1, [1])
    assert len(pairs) == 1 and pairs[0][0] == src
    dst = pairs[0][1]
    assert int(a.table[1, 1]) == dst != src
    assert int(a.ref[src]) == 1 and int(a.ref[dst]) == 1
    assert a.cow_copies == 1 and a.used_blocks == 4
    assert a.match_prefix(toks) == m
    a.release(1)
    assert int(a.ref[m[0]]) == 1
    assert a.prepare_writes(0, [0]) == []       # sole owner: no fork
    assert a.match_prefix(toks) == []


def test_canonical_chain_registration_survives_primary_death():
    a = BlockAllocator(12, 4, 4, 8, share_prefix=True)
    toks = list(range(1, 9))
    assert a.extend(0, 8)
    a.register_prefix(0, toks)
    a.prepare_writes(0, [0, 1])
    m = a.match_prefix(toks)
    assert len(m) == 1
    a.adopt_prefix(1, m)
    assert a.extend(1, 8)
    a.register_prefix(1, toks)
    a.prepare_writes(1, [1])
    dup = int(a.table[1, 1])
    a.release(0)
    m2 = a.match_prefix(toks + list(range(20, 26)))
    assert len(m2) == 2 and m2[1] == dup, (m2, dup)
    assert a.shadow_promotions == 1
    a.prepare_writes(1, [1])
    assert a.match_prefix(toks + [40]) == [m2[0]]


def test_canonical_chain_shadow_dies_with_its_block():
    a = BlockAllocator(12, 4, 4, 8, share_prefix=True)
    toks = list(range(1, 9))
    assert a.extend(0, 8)
    a.register_prefix(0, toks)
    a.prepare_writes(0, [0, 1])
    a.adopt_prefix(1, a.match_prefix(toks))
    assert a.extend(1, 8)
    a.register_prefix(1, toks)
    a.prepare_writes(1, [1])
    a.release(1)
    assert a.shadow_promotions == 0
    assert len(a.match_prefix(toks + [40, 41])) == 2
    a.release(0)
    assert a.match_prefix(toks + [40, 41]) == []
    assert not a._index and not a._shadow and not a._rindex


def test_allocator_cow_fork_requires_free_block():
    a = BlockAllocator(3, 4, 4, 8, share_prefix=True)
    toks = list(range(1, 13))
    a.extend(0, 12)
    a.register_prefix(0, toks)
    a.prepare_writes(0, [0, 1, 2])
    a.adopt_prefix(1, a.match_prefix(toks))
    with pytest.raises(BlockPoolExhausted):
        a.prepare_writes(1, [0])


def test_cached_free_retention_and_revival():
    a = BlockAllocator(8, 4, 4, 8, retain_prefix=True)
    toks = list(range(1, 13))
    assert a.extend(0, 12)
    a.register_prefix(0, toks)
    a.prepare_writes(0, range(3))
    bids = [int(a.table[0, j]) for j in range(3)]
    assert list(a.release(0)) == []
    assert a.cached_blocks == 3 and a.used_blocks == 0
    assert a.free_blocks == 5
    m = a.match_prefix(toks)
    assert m == bids[:2]
    a.adopt_prefix(1, m)
    assert a.revived_blocks == 2
    assert a.cached_blocks == 1 and a.used_blocks == 2
    assert all(int(a.ref[b]) == 1 for b in m)
    assert list(a.release(1)) == []
    assert a.cached_blocks == 3 and a.used_blocks == 0


def test_lru_reclaim_ordering_under_pressure():
    a = BlockAllocator(6, 4, 4, 8, retain_prefix=True)
    t1, t2 = list(range(1, 9)), list(range(21, 29))
    assert a.extend(0, 8)
    a.register_prefix(0, t1)
    a.prepare_writes(0, range(2))
    assert a.extend(1, 8)
    a.register_prefix(1, t2)
    a.prepare_writes(1, range(2))
    bids1 = [int(a.table[0, j]) for j in range(2)]
    a.release(0)
    a.release(1)
    assert a.cached_blocks == 4 and a.free_blocks == 2
    assert a.allocatable_blocks() == 6
    assert a.extend(2, 16)
    assert a.reclaimed_blocks == 2
    assert a.take_reclaimed() == bids1
    assert a.take_reclaimed() == []
    assert a.match_prefix(t1) == []
    assert len(a.match_prefix(t2)) == 1
    assert a.cached_blocks == 2 and a.used_blocks == 4


def test_retain_blocks_cap_evicts_lru():
    a = BlockAllocator(8, 4, 4, 8, retain_prefix=True, retain_blocks=2)
    toks = list(range(1, 13))
    assert a.extend(0, 12)
    a.register_prefix(0, toks)
    a.prepare_writes(0, range(3))
    bids = [int(a.table[0, j]) for j in range(3)]
    assert list(a.release(0)) == [bids[0]]
    assert a.cached_blocks == 2
    assert a.match_prefix(toks) == []
    assert a.match_prefix(toks[:1]) == []


# ---------------------------------------------------------------------------
# Engines and streams against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    slm, llm = tiny_pair(vocab=64)
    slm_p = JM.init_params(slm, jax.random.PRNGKey(0))
    llm_p = JM.init_params(llm, jax.random.PRNGKey(1))
    return dict(
        slm=slm, llm=llm, slm_p=slm_p, llm_p=llm_p,
        t_slm_p=bridge.params_from_reference(
            jax.tree.map(np.asarray, slm_p), device="cpu"),
        t_llm_p=bridge.params_from_reference(
            jax.tree.map(np.asarray, llm_p), device="cpu"))


@pytest.fixture(scope="module")
def devices(weights):
    """The reference paged tests' device runtime, in both packages."""
    kw = dict(s_max=S_MAX, gamma=4, seed=0, use_early_exit=False,
              use_pi=False)
    slm, _ = port_tiny_pair(vocab=64)
    return (RefDevice(weights["slm"], weights["slm_p"],
                      policy=RefPolicy(mode="all"), **kw),
            DeviceRuntime(slm, weights["t_slm_p"],
                          policy=OffloadPolicy(mode="all"), device="cpu",
                          **kw))


def _engines(weights, max_slots=2, s_max=S_MAX, **kw):
    """(reference paged engine, {impl: port paged engine}) with one
    configuration; the reference runs its XLA path (its paged Pallas
    kernels do not run under this jax without an alias)."""
    _, llm = port_tiny_pair(vocab=64)
    ref = RefEngine(weights["llm"], weights["llm_p"], max_slots=max_slots,
                    s_max=s_max, cache_impl="paged", **kw)
    port = {impl: CloudEngine(llm.replace(attn_impl=impl),
                              weights["t_llm_p"], max_slots=max_slots,
                              s_max=s_max, cache_impl="paged", device="cpu",
                              **kw)
            for impl in ("pallas", "blocked")}
    return ref, port


def _assert_pool_equal(eng, ref):
    got, want = eng.pool_stats, ref.pool_stats
    for f in POOL_FIELDS:
        assert got[f] == want[f], (f, got[f], want[f])


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 60, size=L)] for L in lens]


def _shared(common_len, n, suffix_max, seed):
    rng = np.random.default_rng(seed)
    common = [int(t) for t in rng.integers(1, 60, size=common_len)]
    return [common + [int(t) for t in rng.integers(
        1, 60, size=int(rng.integers(1, suffix_max)))] for _ in range(n)]


def _run_waves(weights, devices, waves, max_new, eng_kw, dense_ref=False,
               **run_kw):
    """Serve ``waves`` in order on one reference and two port paged
    engines; every wave's streams, the scheduler counters and the pool
    counters must agree.  Returns the reference engine."""
    rdev, pdev = devices
    ref, port = _engines(weights, **eng_kw)
    rdense = (RefEngine(weights["llm"], weights["llm_p"],
                        max_slots=eng_kw.get("max_slots", 2), s_max=S_MAX)
              if dense_ref else None)
    for wave in waves:
        conc = len(wave)
        want = RSY.run_synera(rdev, ref, wave, max_new, concurrency=conc,
                              **run_kw)
        if rdense is not None:
            dense = RSY.run_synera(rdev, rdense, wave, max_new,
                                   concurrency=1)
            assert want.outputs == dense.outputs
        for impl, eng in port.items():
            got = SY.run_synera(pdev, eng, wave, max_new, concurrency=conc,
                                **run_kw)
            assert got.outputs == want.outputs, impl
            gs, ws = got.extras["scheduler"], want.extras["scheduler"]
            for f in SCHED_FIELDS:
                assert gs[f] == ws[f], (impl, f, gs[f], ws[f])
            _assert_pool_equal(eng, ref)
    for eng in (ref, *port.values()):
        assert eng.allocator.used_blocks == 0
        assert (eng.allocator.free_blocks + eng.allocator.cached_blocks
                == eng.allocator.n_blocks)
    return ref


def _drive_engine(eng):
    """tests/test_paged_cache.py's engine script: prefill, fused feed,
    decode with an idle slot, reset and re-prefill."""
    rng = np.random.default_rng(3)
    B, R = eng.max_slots, eng.verify_rows_max
    out = []
    tokens = np.zeros((B, 12), np.int32)
    positions = np.full((B, 12), -1, np.int32)
    tokens[0, :8] = rng.integers(1, 60, 8)
    positions[0, :8] = np.arange(8)
    tokens[1, :12] = rng.integers(1, 60, 12)
    positions[1, :12] = np.arange(12)
    out.append(eng.prefill(tokens, positions))
    t2 = np.zeros((B, 6), np.int32)
    p2 = np.full((B, 6), -1, np.int32)
    tg = np.full((B, 6), -1, np.int32)
    sel = np.full((B, R), -1, np.int32)
    t2[0] = rng.integers(1, 60, 6)
    p2[0] = 8 + np.arange(6)
    t2[1] = rng.integers(1, 60, 6)
    p2[1] = 12 + np.arange(6)
    tg[:, :5] = t2[:, 1:]
    sel[:, :3] = [3, 4, 5]
    rows = eng.feed(t2, p2, tg, sel, need_dists=True)
    out += [rows.token_id, rows.p_draft, rows.topk_idx, rows.topk_val]
    td = np.zeros((B, 1), np.int32)
    pd = np.full((B, 1), -1, np.int32)
    td[0, 0], pd[0, 0] = 5, 14
    d = eng.decode(td, pd)
    # slot 1 is idle: the kernels give 0 where XLA's unguarded softmax
    # averages V, so only the live slot is compared
    out += [d.token_id[:1], d.topk_idx[:1], d.topk_val[:1]]
    eng.reset_slot(1)
    t3 = np.zeros((B, 4), np.int32)
    p3 = np.full((B, 4), -1, np.int32)
    t3[1] = rng.integers(1, 60, 4)
    p3[1] = np.arange(4)
    out.append(eng.prefill(t3, p3))
    eng.reset_slot(0)
    eng.reset_slot(1)
    return out


def test_engine_steps_match_reference(weights):
    ref, port = _engines(weights, s_max=64, block_size=8, pool_blocks=12)
    want = _drive_engine(ref)
    for impl, eng in port.items():
        got = _drive_engine(eng)
        for i in (1, 3, 5, 6):                     # token ids
            assert np.array_equal(got[i], np.asarray(want[i])), (impl, i)
        for i in (0, 2, 4, 7, 8):                  # logits and probabilities
            np.testing.assert_allclose(got[i], np.asarray(want[i]),
                                       atol=2e-5, rtol=2e-5)
        _assert_pool_equal(eng, ref)
        assert eng.allocator.used_blocks == 0
        # every freed block was invalidated
        assert (eng.cache["layers"]["pos"] == -1).all()


def _drive_cow_script(eng):
    """tests/test_prefix_sharing.py's script: two slots prefill the same
    prompt (the second adopts it), slot 1 rewrites positions 4..7 inside
    the shared region (a forced copy-on-write fork), both decode."""
    rng = np.random.default_rng(13)
    P = [int(t) for t in rng.integers(1, 60, size=12)]
    B = eng.max_slots
    out = []

    def prefill(slot, m):
        n = len(P) - m
        t = np.zeros((B, n), np.int32)
        p = np.full((B, n), -1, np.int32)
        t[slot, :n] = P[m:]
        p[slot, :n] = np.arange(m, len(P))
        return eng.prefill(t, p)

    out.append(prefill(0, eng.alloc_prompt(0, P)))
    m1 = eng.alloc_prompt(1, P)
    out.append(prefill(1, m1))
    t = np.zeros((B, 4), np.int32)
    p = np.full((B, 4), -1, np.int32)
    t[1, :] = [int(x) for x in rng.integers(1, 60, size=4)]
    p[1, :] = 4 + np.arange(4)
    out.append(eng.feed(t, p, need_dists=False).token_id)
    td = np.full((B, 1), 7, np.int32)
    pd = np.full((B, 1), -1, np.int32)
    pd[0, 0] = pd[1, 0] = 12
    d = eng.decode(td, pd)
    out += [d.token_id, d.topk_idx, d.topk_val]
    return out, m1


def test_forced_cow_fork_matches_reference(weights):
    ref, port = _engines(weights, s_max=64, block_size=4, share_prefix=True)
    want, m_ref = _drive_cow_script(ref)
    assert m_ref == 11 and ref.allocator.cow_copies == 1
    for impl, eng in port.items():
        got, m = _drive_cow_script(eng)
        assert m == m_ref
        for i in (2, 3, 4):
            assert np.array_equal(got[i], np.asarray(want[i])), (impl, i)
        for i in (0, 1, 5):
            np.testing.assert_allclose(got[i], np.asarray(want[i]),
                                       atol=2e-5, rtol=2e-5)
        _assert_pool_equal(eng, ref)
        assert eng.allocator.shared_blocks == 1
        for s in (0, 1):
            eng.reset_slot(s)
        assert eng.allocator.used_blocks == 0


def test_plain_paged_streams_match_reference(weights, devices, monkeypatch):
    """Also checks that ``attn_impl="pallas"`` reads the pool through the
    block-table kernels' dispatch (decode and partial prefill) and never
    through the gathered view."""
    calls = {"decode": 0, "chunk": 0}
    dispatch = L.paged_pallas_attention

    def counting(q, *a, **k):
        calls["decode" if q.shape[1] == 1 else "chunk"] += 1
        return dispatch(q, *a, **k)

    monkeypatch.setattr(L, "paged_pallas_attention", counting)
    waves = [_prompts([8, 13, 20], seed=5)]
    _run_waves(weights, devices, waves, 10, dict(block_size=4),
               dense_ref=True)
    assert calls["chunk"] > 0
    rdev, pdev = devices
    _, port = _engines(weights, block_size=4)
    before = dict(calls)
    got = SY.run_cloud_centric(port["pallas"], waves[0][:1], 6)
    assert calls["decode"] > before["decode"]
    ref = RefEngine(weights["llm"], weights["llm_p"], max_slots=2,
                    s_max=S_MAX)
    assert got.outputs == RSY.run_cloud_centric(ref, waves[0][:1], 6).outputs


def test_shared_prefix_streams_match_reference(weights, devices):
    """Four streams on a 3-block common prompt: dedupe hits, the
    identical last full block registered as a canonical-chain shadow."""
    waves = [_shared(12, 4, 6, seed=11)]
    ref = _run_waves(weights, devices, waves, 10,
                     dict(max_slots=4, block_size=4, share_prefix=True),
                     dense_ref=True)
    assert ref.pool_stats["dedupe_hit_blocks"] > 0


def test_retained_prefix_two_waves_match_reference(weights, devices):
    """Retention on a tight pool: wave 2 revives wave 1's cached prefix
    blocks, and a wave of other prompts reclaims them under pressure."""
    common = _shared(12, 1, 2, seed=21)[0][:12]
    rng = np.random.default_rng(22)
    waves = [[common + _prompts([3], seed=s)[0] for s in (1, 2)],
             [common + _prompts([5], seed=s)[0] for s in (3, 4)],
             _prompts([9, 11], seed=int(rng.integers(100)))]
    ref = _run_waves(weights, devices, waves, 8,
                     dict(block_size=4, pool_blocks=14, retain_prefix=True))
    st = ref.pool_stats
    assert st["revived_blocks"] > 0 and st["reclaimed_blocks"] > 0


def test_swapping_streams_match_reference(weights, devices):
    """A pool forced dry preempts through the host swap tier."""
    waves = [_prompts([8, 8, 8, 8], seed=29)]
    ref = _run_waves(weights, devices, waves, 12,
                     dict(block_size=4, pool_blocks=11, swap=True),
                     dense_ref=True)
    st = ref.pool_stats
    assert st["swap_out_bytes"] > 0 and st["swap_in_bytes"] > 0


def test_host_dedupe_adopts_from_host_like_reference(weights, devices):
    """Retention off, content-addressed host store on: wave 1 demotes its
    prefix chain at exit, wave 2 adopts it by H2D scatter."""
    rng = np.random.default_rng(303)
    common = [int(t) for t in rng.integers(1, 60, size=24)]
    waves = [[common + _prompts([int(n)], seed=s)[0]
              for s, n in ((31, 3), (32, 6))],
             [common + _prompts([int(n)], seed=s)[0]
              for s, n in ((33, 2), (34, 5))]]
    ref = _run_waves(weights, devices, waves, 8,
                     dict(max_slots=4, block_size=8, share_prefix=True,
                          swap=True, host_dedupe=True))
    st = ref.pool_stats
    assert st["host_adopted_blocks"] > 0 and st["demoted_blocks"] > 0
    assert st["adopt_in_bytes"] > 0


def test_reference_pool_deadlock_reproduced(weights, devices):
    """ROADMAP queue 3, R2: lens [4, 17, 13], youngest-victim policy,
    arriving together, on an 11-block pool of 4-token blocks without
    swap.  The reference's deferral rule withdraws the youngest needy
    chunk, which is the only block holder, behind an older from-scratch
    restart that holds nothing, so no chunk ever runs; the port carries
    the scheduler over whole and deadlocks the same way."""
    rdev, pdev = devices
    lens = [4, 17, 13]
    rng = np.random.default_rng(sum(lens) + 13 * len(lens))
    prompts = [[int(t) for t in rng.integers(1, 60, size=L)] for L in lens]
    ref, port = _engines(weights, block_size=4, pool_blocks=11)
    with pytest.raises(RuntimeError, match="deadlocked") as want:
        RSY.run_synera(rdev, ref, prompts, 10, concurrency=3,
                       preempt_policy="youngest")
    with pytest.raises(RuntimeError, match="deadlocked") as got:
        SY.run_synera(pdev, port["blocked"], prompts, 10, concurrency=3,
                      preempt_policy="youngest")
    assert str(got.value) == str(want.value)


class _Livelock(Exception):
    pass


def _count_evictions(monkeypatch, scheduler_cls, limit=40):
    """Make one verify iteration that evicts more than ``limit`` times
    raise :class:`_Livelock` (a pool of at most four slots never needs
    that many); returns the list of iterations run so far."""
    evict, run = scheduler_cls._evict, scheduler_cls.run_iteration
    state = {"evictions": 0, "iterations": 0}

    def counted_evict(self, *a, **k):
        state["evictions"] += 1
        if state["evictions"] > limit:
            raise _Livelock(state["iterations"])
        return evict(self, *a, **k)

    def counted_run(self, *a, **k):
        state["evictions"] = 0
        state["iterations"] += 1
        return run(self, *a, **k)

    monkeypatch.setattr(scheduler_cls, "_evict", counted_evict)
    monkeypatch.setattr(scheduler_cls, "run_iteration", counted_run)
    return state


# ROADMAP queue 3, R3-R5: faults of the reference's scheduler under
# ``retain_prefix`` with preemption, each reached by both packages on the
# same input with the same error.  R3: a recompute-evicted stream
# re-adopts its own retained blocks at once, so the eviction frees
# nothing, yet ``_evict`` reports success and ``_reserve_blocks`` picks the
# same victim again without end.  R4: a swap-in re-adopts its shared lead
# into a slot that already holds blocks.  R5: a step needs more blocks
# than the pool has free, which admission should have prevented.
RETAIN_FAULTS = {
    "R3 livelock": (_prompts([21, 18, 12, 13], seed=7),
                    dict(pool_blocks=14), _Livelock, None),
    "R4 swap-in adoption": (_shared(8, 4, 20, seed=4),
                            dict(pool_blocks=17, swap=True), AssertionError,
                            "prefix adoption requires"),
    "R5 pool exhausted": (_shared(8, 4, 20, seed=4),
                          dict(pool_blocks=12, swap=True), RuntimeError,
                          "needs 7 more KV blocks"),
}


@pytest.mark.parametrize("fault", list(RETAIN_FAULTS))
def test_reference_retained_preemption_faults_reproduced(weights, devices,
                                                         monkeypatch, fault):
    from repro.serving import scheduler as RS
    from repro_torch.serving import scheduler as S
    prompts, kw, err, match = RETAIN_FAULTS[fault]
    rdev, pdev = devices
    ref, port = _engines(weights, max_slots=4, block_size=4,
                         retain_prefix=True, **kw)
    got = {}
    for name, mod, run in (
            ("reference", RS, lambda: RSY.run_synera(
                rdev, ref, prompts, 12, concurrency=4)),
            ("port", S, lambda: SY.run_synera(
                pdev, port["pallas"], prompts, 12, concurrency=4))):
        state = _count_evictions(monkeypatch, mod.VerificationAwareScheduler)
        with pytest.raises(err, match=match) as exc:
            run()
        got[name] = (str(exc.value), state["iterations"])
    assert got["port"] == got["reference"]
