"""The port's serve launcher and the modules it stands on, against the
reference.

* ``core/verifier.verify_greedy_batched``, ``data/synthetic`` and the
  launcher's evaluation helpers (``launch/evalset.py``) against their
  reference counterparts on fixed seeds;
* the checkpoint reader (``checkpoint/io.py``) on trees saved by the
  reference's ``checkpoint/io.save``;
* the launcher itself: the reference's ``repro.launch.serve.main`` and
  the port's ``main`` read the same saved tiny pair (``results/ckpt``
  under a temporary directory, where the reference's ``get_pair`` loads
  instead of training) with the same argv, and print the same summary.
  The reference launcher runs once for the module.
"""
import contextlib
import hashlib
import io
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint import io as ref_ckpt
from repro.configs.synera_pair import tiny_pair
from repro.core import verifier as RV
from repro.data import synthetic as RD
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.core import verifier as V
from repro_torch.data import synthetic as D
from repro_torch.launch import evalset as PE
from repro_torch.launch import serve
from repro_torch.serving import synergy as SY
from repro_torch.serving.link import LinkModel
from test_torch_fleet import assert_same_values

ROOT = Path(__file__).resolve().parents[1]
# --budget 1.0: at the default 0.2 the randomly initialised SLM's profiled
# thresholds offload nothing, and the fleet would never reach the cloud
FLEET_ARGV = ["--mode", "synera", "--replicas", "2",
              "--route-policy", "prefix-affinity", "--cache-impl", "paged",
              "--share-prefix", "--shared-prefix-tokens", "16",
              "--requests", "3", "--max-new", "8", "--budget", "1.0",
              "--json"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Small modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True)])
def test_verify_greedy_batched_matches_reference(seed, ties):
    rng = np.random.default_rng(seed)
    B, gamma, vocab = 16, 4, 32
    logits = (rng.integers(0, 3, (B, gamma + 1, vocab)) if ties
              else rng.normal(size=(B, gamma + 1, vocab))).astype(np.float32)
    tops = logits.argmax(-1)
    # about half the drafts follow the argmax for a while
    draft = np.where(rng.random((B, gamma)) < 0.8, tops[:, :gamma],
                     rng.integers(0, vocab, (B, gamma)))
    want = RV.verify_greedy_batched(jnp.asarray(draft), jnp.asarray(logits))
    got = V.verify_greedy_batched(torch.from_numpy(draft),
                                  torch.from_numpy(logits))
    for g, w in zip(got, want):
        assert g.numpy().tolist() == np.asarray(w).tolist()
    for i in range(B):
        res = V.verify_greedy(draft[i], logits[i])
        assert int(got[0][i]) == res.n_accepted


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_task_matches_reference(seed):
    spec = dict(vocab=64, seed=1234 + seed)
    ref, port = RD.SyntheticTask(RD.TaskSpec(**spec)), \
        D.SyntheticTask(D.TaskSpec(**spec))
    seq_r, reg_r = ref.sample_sequence(200, np.random.default_rng(seed))
    seq_p, reg_p = port.sample_sequence(200, np.random.default_rng(seed))
    assert np.array_equal(seq_r, seq_p) and np.array_equal(reg_r, reg_p)
    cr, rr = ref.corpus(n_sequences=4, length=128, seed=seed)
    cp, rp = port.corpus(n_sequences=4, length=128, seed=seed)
    assert np.array_equal(cr, cp) and np.array_equal(rr, rp)
    noisy = seq_r.copy()
    noisy[100::7] = (noisy[100::7] + 1) % spec["vocab"]
    for s in (seq_r, noisy):
        assert port.score(s, reg_p, 100) == ref.score(s, reg_r, 100)


@pytest.fixture(scope="module")
def paper_claims():
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        from benchmarks import paper_claims
        yield paper_claims


@pytest.mark.parametrize("n,seed", [(3, 7), (5, 11)])
def test_eval_set_and_scores_match_reference(paper_claims, n, seed):
    ref_task = RD.SyntheticTask(RD.TaskSpec(vocab=64))
    task = D.SyntheticTask(D.TaskSpec(vocab=64))
    want = paper_claims.eval_set(ref_task, n, seed=seed)
    got = PE.eval_set(task, n, seed=seed)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    assert (PE.GAMMA, PE.S_MAX, PE.PLEN, PE.GEN) == (
        paper_claims.GAMMA, paper_claims.S_MAX, paper_claims.PLEN,
        paper_claims.GEN)
    rng = np.random.default_rng(seed)
    outputs = [rng.integers(0, 64, PE.GEN).tolist() for _ in range(n)]
    assert PE.score_outputs(task, got, outputs) == \
        paper_claims.score_outputs(ref_task, want, outputs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_reader_matches_bridge(tmp_path, dtype):
    slm, _ = tiny_pair(vocab=64)
    slm = slm.replace(dtype=dtype)
    tree = JM.init_params(slm, jax.random.PRNGKey(3))
    path = tmp_path / "results" / "ckpt" / f"{slm.name}.npz"
    ref_ckpt.save(str(path), tree)
    port_cfg = port_tiny_pair(vocab=64)[0].replace(dtype=dtype)
    got = ckpt.load(str(path), port_cfg, device="cpu")
    want = bridge.params_from_reference(jax.tree.map(np.asarray, tree),
                                        device="cpu")

    def walk(g, w, path=""):
        assert set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{path}/{k}")
            else:
                assert g[k].dtype == w[k].dtype, (path, k)
                assert torch.equal(g[k], w[k]), (path, k)

    walk(got, want)
    assert got["embed"].dtype == getattr(torch, dtype)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """The reference's tiny pair (PRNGKey 0 / 1) saved where both
    launchers look by default: ``results/ckpt`` under the directory the
    launcher runs in."""
    root = tmp_path_factory.mktemp("launch")
    slm, llm = tiny_pair(vocab=64)
    for i, cfg in enumerate((slm, llm)):
        ref_ckpt.save(str(root / "results" / "ckpt" / f"{cfg.name}.npz"),
                      JM.init_params(cfg, jax.random.PRNGKey(i)))
    return root


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _run_port(root, argv):
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.chdir(root)
        ret = serve.main(argv + ["--device", "cpu"])
    assert _summary(buf.getvalue()) == ret
    return ret


@pytest.fixture(scope="module")
def summaries(ckpt_dir):
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.chdir(ckpt_dir)
        mp.syspath_prepend(str(ROOT))
        mp.setattr(sys, "argv", ["serve"] + FLEET_ARGV)
        from repro.launch import serve as ref_serve
        ref_serve.main()
    return _summary(buf.getvalue()), _run_port(ckpt_dir, FLEET_ARGV)


def test_launcher_summary_matches_reference(summaries):
    want, got = summaries
    assert list(got) == list(want)          # same keys, same order
    # the port holds one block table where the reference holds one per
    # layer (tiny LLM: 6 layers; 4 slots x 12 blocks of int32 a replica)
    table = 4 * (192 // 16) * 4
    assert want["kv_cache_bytes"] - got["kv_cache_bytes"] == 2 * 5 * table
    assert_same_values(dict(got, kv_cache_bytes=want["kv_cache_bytes"]), want)
    assert got["replicas"] == 2 and got["route_policy"] == "prefix-affinity"
    assert got["iterations"] > 0            # the fleet verified on the cloud


def _sha(outputs):
    return hashlib.sha256(json.dumps(
        [[int(t) for t in o] for o in outputs]).encode()).hexdigest()[:16]


def _eval_prompts(args_seed, requests, shared):
    task = D.SyntheticTask(D.TaskSpec(vocab=64))
    prompts = [p for p, _ in PE.eval_set(task, requests, seed=args_seed + 7)]
    if shared:
        rng = np.random.default_rng(args_seed + 29)
        common = [int(t) for t in rng.integers(1, 64 - 1, shared)]
        prompts = [common + p for p in prompts]
    return prompts


def test_launcher_cloud_mode_matches_run_cloud_centric(ckpt_dir):
    argv = ["--mode", "cloud", "--cache-impl", "paged", "--share-prefix",
            "--shared-prefix-tokens", "16", "--requests", "3",
            "--max-new", "8", "--json"]
    got = _run_port(ckpt_dir, argv)
    slm_cfg, slm_p, llm_cfg, llm_p, _ = serve.load_pair(
        str(ckpt_dir / "results" / "ckpt"), random_weights=False, seed=0,
        device="cpu")
    eng = PE.make_engine(llm_cfg, llm_p, slots=4, cache_impl="paged",
                         share_prefix=True, device="cpu")
    ref = SY.run_cloud_centric(eng, _eval_prompts(0, 3, 16), 8,
                               link=LinkModel(bandwidth_mbps=10.0))
    assert got["mode"] == "cloud" and got["outputs_sha"] == _sha(ref.outputs)
    assert math.isclose(got["tbt_ms"], ref.tbt_ms, rel_tol=1e-9)


def test_launcher_edge_mode_matches_run_edge_centric(ckpt_dir):
    from repro_torch.core.offload import OffloadPolicy
    got = _run_port(ckpt_dir, ["--mode", "edge", "--requests", "3",
                               "--max-new", "8", "--seed", "2", "--json"])
    slm_cfg, slm_p, *_ = serve.load_pair(
        str(ckpt_dir / "results" / "ckpt"), random_weights=False, seed=2,
        device="cpu")
    dev = PE.make_device(slm_cfg, slm_p, link=LinkModel(bandwidth_mbps=10.0),
                         gamma=4, seed=2, policy=OffloadPolicy(mode="none"),
                         device="cpu")
    ref = SY.run_edge_centric(dev, _eval_prompts(2, 3, 0), 8)
    assert got["mode"] == "edge" and got["outputs_sha"] == _sha(ref.outputs)


def test_launcher_random_weights_fleet_matches_single_replica(tmp_path):
    """``--random-weights`` needs no checkpoint; two replicas under
    prefix affinity serve the one-replica streams.  A full budget makes
    the random SLM offload (its profiled thresholds offload nothing at
    0.2), and retained prefixes outlive each stream, so every later
    placement finds the shared one."""
    argv = ["--random-weights", "--budget", "1.0", "--attn-impl", "pallas",
            "--cache-impl", "paged", "--share-prefix", "--retain-prefix",
            "--shared-prefix-tokens", "32", "--requests", "3",
            "--max-new", "8", "--json"]
    one = _run_port(tmp_path, argv + ["--replicas", "1"])
    two = _run_port(tmp_path, argv + ["--replicas", "2", "--route-policy",
                                      "prefix-affinity"])
    assert one["outputs_sha"] == two["outputs_sha"]
    assert one["iterations"] > 0 and two["iterations"] > 0
    assert two["replicas"] == 2 and two["affinity_hits"] >= 1


def test_launcher_refuses_without_checkpoint_or_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="benchmarks.prepare"):
        serve.main(["--requests", "1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1", "--random-weights"])
