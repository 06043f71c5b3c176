"""A prefill runs only the slots that hold a prompt, on the CPU: the
dense ``partial_prefill`` and the plain attention paths read a slot index
(``slots=``) as they would read the gathered cache rows, and
``CloudEngine.prefill``'s compacted sub-chunks (``models.model.slot_view``)
leave the same last rows and the same cache contents as the full-width
forward (dense and paged engines bit for bit, the MoE to f32 rounding),
touch no other slot, and count their slots in
``compile_stats()["slots_run"]``.  The kernel's slot index runs through
``tools/cuda_emu`` (the CUDA source compiled for the CPU).  Port-only: random
weights drawn by ``init_params``, the tiny LLM at vocab 64, f32."""
import numpy as np
import pytest
import torch

from repro_torch.configs.synera_pair import tiny_pair
from repro_torch.kernels.partial_prefill import partial_prefill_attention
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.serving.engine import CloudEngine

BUCKETS = (8, 16, 32)        # a 45-token prompt takes two sub-chunks
SLOTS = 4
# slot -> prompt: the slots the compacted prefill fills, then fillers
PROMPTS = {1: list(range(5, 50)), 3: [9, 4, 17, 2, 30, 11, 8, 3, 1, 60, 22]}
FILLERS = {0: list(range(40, 0, -1)), 2: [7, 7, 3, 1, 2, 9, 14, 5, 6]}
# (fields of the tiny LLM, engine keyword arguments)
ENGINES = {
    "dense": ({}, {}),
    "paged": ({}, dict(cache_impl="paged", block_size=16)),
    "moe": (dict(family="moe", n_layers=2, n_experts=4, top_k=2), {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(prompts, width=None):
    width = width or max(map(len, prompts.values()))
    tok = np.zeros((SLOTS, width), np.int32)
    pos = np.full((SLOTS, width), -1, np.int32)
    for s, p in prompts.items():
        tok[s, :len(p)] = p
        pos[s, :len(p)] = np.arange(len(p))
    return tok, pos


def _kv(eng):
    """Each layer's (k, v, pos) as dense slot-major tensors (a paged
    pool through its tables)."""
    stack = eng.cache["layers"]
    out = []
    for i in range(stack["k"].shape[0]):
        lc = TM.layer_slice(stack, i)
        out.append(L.paged_kv_view(lc) if L.is_paged(lc)
                   else (lc["k"], lc["v"], lc["pos"]))
    return out


# -- the slot index in attention --------------------------------------------

# (B, C, S, nh, nkv, hd, cache slots, window)
CASES = [(2, 8, 64, 4, 4, 16, 5, 0), (1, 16, 96, 8, 2, 32, 4, 0),
         (3, 8, 64, 16, 4, 64, 3, 24)]


def _slot_case(B, C, S, nh, nkv, hd, n_cache, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    q = torch.randn(B, C, nh, hd, generator=g).to(dtype)
    k, v = (torch.randn(n_cache, S, nkv, hd, generator=g).to(dtype)
            for _ in range(2))
    kp = np.full((n_cache, S), -1, np.int32)
    qp = np.full((B, C), -1, np.int32)
    for b in range(n_cache):          # rows no query reads hold keys too
        n = int(rng.integers(C, S))
        kp[b, :n] = np.arange(n)
    slots = rng.choice(n_cache, B, replace=False).astype(np.int32)
    for i, b in enumerate(slots):
        n = int(rng.integers(1, S - C))
        nq = int(rng.integers(1, C + 1))
        kp[b, :n + nq] = np.arange(n + nq)
        qp[i, :nq] = n + np.arange(nq)
    return (q, k, v, torch.from_numpy(qp), torch.from_numpy(kp),
            torch.from_numpy(slots))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_partial_prefill_slot_index_reads_the_gathered_rows(case, dtype):
    B, C, S, nh, nkv, hd, n_cache, window = case
    q, k, v, qp, kp, s = _slot_case(B, C, S, nh, nkv, hd, n_cache, dtype)
    kw = dict(window=window) if window else {}
    got = partial_prefill_attention(q, k, v, qp, kp, slots=s, **kw)
    want = partial_prefill_attention(q, k[s.long()], v[s.long()], qp,
                                     kp[s.long()], **kw)
    assert torch.equal(got, want)
    assert bool((got[qp < 0] == 0).all())


def test_cuda_kernel_reads_the_slot_index(tmp_path, monkeypatch):
    """csrc/partial_prefill.cu compiled for the CPU (tools/cuda_emu: every
    CUDA thread a host thread): query slot b on cache row ``slots[b]``
    gives the bits of the unindexed launch on the gathered rows, and the
    plain version's values, with and without split-KV."""
    import importlib.util
    import shutil
    from pathlib import Path
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    path = (Path(__file__).resolve().parents[1] / "tools" / "cuda_emu"
            / "emulate.py")
    spec = importlib.util.spec_from_file_location("_cuda_emu", path)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    monkeypatch.setattr(emu, "OUT", tmp_path)   # no build shared with others
    fn = emu.load("partial_prefill").partial_prefill_launch
    assert emu.check_partial_prefill_slots(fn)


@pytest.mark.parametrize("impl", ["naive", "blocked", "pallas"])
def test_attention_slot_index_reads_the_gathered_rows(impl):
    B, C, S, nh, nkv, hd, n_cache, window = CASES[1]
    q, k, v, qp, kp, s = _slot_case(B, C, S, nh, nkv, hd, n_cache,
                                    torch.float32, seed=3)
    got, _ = L.attention(q, k, v, qp, kp, impl=impl, block_kv=32, slots=s)
    want, _ = L.attention(q, k[s.long()], v[s.long()], qp, kp[s.long()],
                          impl=impl, block_kv=32)
    assert torch.equal(got, want)


def test_cache_write_addresses_rows_through_the_slot_index():
    k = torch.zeros(4, 8, 1, 2)
    cache = {"k": k, "v": k.clone(), "pos": torch.full((4, 8), -1,
                                                        dtype=torch.int32),
             "slots": torch.tensor([3, 0], dtype=torch.int32)}
    new = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 1, 2)
    pos = torch.tensor([[5, 6, -1], [0, 1, 2]], dtype=torch.int32)
    L.cache_write(cache, new, new, pos)
    assert cache["pos"][3].tolist() == [-1] * 5 + [5, 6, -1]
    assert cache["pos"][0].tolist() == [0, 1, 2] + [-1] * 5
    assert (cache["pos"][1:3] == -1).all() and (cache["k"][1:3] == 0).all()
    assert torch.equal(cache["k"][3, 5:7], new[0, :2])
    assert torch.equal(cache["v"][0, :3], new[1])


def test_slot_view_refuses_state_it_cannot_address():
    slots = torch.tensor([1], dtype=torch.int32)
    dense = {"layers": {"k": torch.zeros(1), "v": torch.zeros(1),
                        "pos": torch.zeros(1)}}
    assert TM.slot_view(dense, slots)["layers"]["slots"] is slots
    cross = {"self": dense["layers"], "cross": {"k": torch.zeros(1),
                                                "v": torch.zeros(1)}}
    assert TM.slot_view(cross, slots) is None
    ssm = {"layers": {"conv": torch.zeros(1), "state": torch.zeros(1)}}
    assert TM.slot_view(ssm, slots) is None


# -- the engine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    _, llm = tiny_pair(vocab=64)
    llm = llm.replace(attn_impl="pallas")
    out = {}
    for name, (fields, _) in ENGINES.items():
        cfg = llm.replace(**fields)
        out[name] = (cfg, TM.init_params(cfg, 1, device="cpu"))
    return out


def _engine(models, name):
    cfg, params = models[name]
    return CloudEngine(cfg, params, max_slots=SLOTS, s_max=128,
                       feed_buckets=BUCKETS, device="cpu",
                       **ENGINES[name][1])


@pytest.fixture(scope="module", params=list(ENGINES))
def served(request, models):
    """The compacted engine: the fillers' prefill, their cache rows then,
    and the prompts' prefill; the full-width engine (no slot view): all
    four prompts in one prefill."""
    name = request.param
    eng = _engine(models, name)
    first = eng.prefill(*_batch(FILLERS))
    before = [tuple(t.clone() for t in layer) for layer in _kv(eng)]
    last = eng.prefill(*_batch(PROMPTS))
    full = _engine(models, name)
    mp = pytest.MonkeyPatch()
    mp.setattr(TM, "slot_view", lambda cache, slots: None)
    try:
        full_last = full.prefill(*_batch({**FILLERS, **PROMPTS}))
    finally:
        mp.undo()
    return dict(name=name, eng=eng, full=full, first=first, last=last,
                before=before, full_last=full_last)


def _same(name, got, want):
    """Bit for bit; the MoE to f32 rounding: on the CPU each expert's
    group is one plain matrix product, and a group's row count follows
    the batch, so the product's f32 sums may round otherwise."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if name == "moe":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)


def test_compacted_prefill_gives_the_full_width_rows(served):
    name = served["name"]
    for s in PROMPTS:
        _same(name, served["last"][s], served["full_last"][s])
    for s in FILLERS:
        _same(name, served["first"][s], served["full_last"][s])
        assert not served["last"][s].any()     # no prompt in this prefill
    for (k, v, p), (fk, fv, fp) in zip(_kv(served["eng"]),
                                       _kv(served["full"])):
        for s in range(SLOTS):
            assert torch.equal(p[s], fp[s])
            real = p[s] >= 0
            _same(name, k[s][real], fk[s][real])
            _same(name, v[s][real], fv[s][real])


def test_compacted_prefill_touches_no_other_slot(served):
    for (k, v, p), (bk, bv, bp) in zip(_kv(served["eng"]),
                                       served["before"]):
        for s in FILLERS:
            assert torch.equal(p[s], bp[s])
            assert torch.equal(k[s], bk[s]) and torch.equal(v[s], bv[s])


def _slots_per_subchunk(prompts):
    tok, pos = _batch(prompts)
    top = BUCKETS[-1]
    return [int((pos[:, off:off + top] >= 0).any(1).sum())
            for off in range(0, tok.shape[1], top)]


def test_slots_run_counts_the_real_slots_per_subchunk(served):
    st = served["eng"].compile_stats
    chunks = _slots_per_subchunk(FILLERS) + _slots_per_subchunk(PROMPTS)
    assert chunks == [2, 1, 2, 1]
    assert st["forwards"]["prefill"] == len(chunks)
    assert st["slots_run"]["prefill"] == sum(chunks) == 6
    # the full-width engine ran every slot in both sub-chunks
    full = served["full"].compile_stats
    assert full["slots_run"]["prefill"] == SLOTS * 2
    assert st["rows_real"]["prefill"] == full["rows_real"]["prefill"]
    assert st["rows_run"]["prefill"] < full["rows_run"]["prefill"]
