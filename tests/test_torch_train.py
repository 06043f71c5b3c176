"""Port of the training path against the reference, on the CPU: the loss,
its gradients, the train step (one and two micro-batches), AdamW, the
cosine schedule, global-norm clipping, weight quantization, checkpoint
saving and the training launcher.  The model is the tiny SLM in float32
with the reference's own parameters, through ``repro_torch.bridge``.

Tolerances: the loss and every metric within 1e-5 (the two packages sum
in other orders); each gradient leaf within 1e-4 of its largest |value|;
AdamW given the same gradients within 1e-6; quantization exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import io as ref_io
from repro.configs.synera_pair import tiny_pair
from repro.launch import train as ref_train
from repro.models import model as JM
from repro.models import steps as JS
from repro.optim import adamw as JA
from repro.optim import quantize as JQ
from repro_torch import bridge
from repro_torch.checkpoint import io as port_io
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.data.synthetic import SyntheticTask, TaskSpec
from repro_torch.launch import train as port_train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import steps as TS
from repro_torch.optim import adamw as TA
from repro_torch.optim import quantize as TQ
from repro_torch.tree import flatten

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
B, T = 4, 32
LR = 3e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_np(tree) -> dict:
    """{path: float32 numpy} of a reference (jax / numpy) or port tree."""
    return {p: np.asarray(v.detach().float() if isinstance(v, torch.Tensor)
                          else jnp.asarray(v, jnp.float32))
            for p, v in flatten(tree)}


def assert_grads_close(ref, port, rel=GRAD_REL):
    """Each leaf within ``rel`` of the reference leaf's largest |value|."""
    r, t = flat_np(ref), flat_np(port)
    assert r.keys() == t.keys()
    for p in r:
        scale = max(float(np.abs(r[p]).max()), 1e-30)
        err = float(np.abs(r[p] - t[p]).max())
        assert err <= rel * scale, (p, err, scale)


def assert_step_close(ref_new, port_new, ref_grads, old, lr):
    """Parameters after one AdamW step.  Within 1e-5 wherever the
    reference gradient lies above the gradient tolerance (1e-4 of the
    leaf's largest |value|).  Below it the two packages' gradients agree
    only to within their own rounding, and Adam's first step is
    g / (|g| + eps), about sign(g): there a step of either sign is right,
    so the check is the step's bound, 2 lr (1 + wd |p|) apart at most."""
    r, t, g, p0 = (flat_np(x) for x in (ref_new, port_new, ref_grads, old))
    for k in r:
        err = np.abs(r[k] - t[k])
        resolved = np.abs(g[k]) > GRAD_REL * max(float(np.abs(g[k]).max()),
                                                 1e-30)
        assert float(err[resolved].max(initial=0.0)) <= PARAM_ATOL, k
        bound = 2 * lr * (1 + 0.01 * np.abs(p0[k])) + PARAM_ATOL
        assert bool((err <= bound).all()), k
        # entries off by more than 1e-5 are a small minority
        assert (err > PARAM_ATOL).mean() < 1e-3, k


@pytest.fixture(scope="module")
def dense():
    jcfg, _ = tiny_pair(vocab=64)
    tcfg, _ = port_tiny_pair(vocab=64)
    jp = jax.tree.map(np.array, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (B, T))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(jcfg, p, jb), has_aux=True))(jp)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, toks=toks, jb=jb,
                tb={"tokens": torch.as_tensor(toks)},
                tp=bridge.params_from_reference(jp, device="cpu"),
                loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, grads))


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

def test_lm_loss_matches_reference(dense):
    loss, metrics = TM.lm_loss(dense["tcfg"], dense["tp"], dense["tb"])
    np.testing.assert_allclose(float(loss), dense["loss"], **LOSS_TOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(metrics[k]), dense["metrics"][k],
                                   **LOSS_TOL)


def test_grads_match_reference(dense):
    (loss, _), grads = TS.loss_and_grad(dense["tcfg"], dense["tp"],
                                        dense["tb"])
    np.testing.assert_allclose(float(loss), dense["loss"], **LOSS_TOL)
    assert_grads_close(dense["grads"], grads)
    # the caller's parameters are left as they were
    assert not any(t.requires_grad for _, t in flatten(dense["tp"]))


def test_remat_recomputes_each_layer(dense, monkeypatch):
    """``remat=True`` wraps each layer in ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): one call per layer, the same loss and
    gradients, and nothing in a forward without grad."""
    calls = []
    real = TM.checkpoint

    def counting(fn, *a, **k):
        calls.append(fn.__name__)
        return real(fn, *a, **k)

    monkeypatch.setattr(TM, "checkpoint", counting)
    cfg = dense["tcfg"].replace(remat=True)
    (loss, _), grads = TS.loss_and_grad(cfg, dense["tp"], dense["tb"])
    assert calls == ["_layer"] * cfg.n_layers
    (loss0, _), grads0 = TS.loss_and_grad(dense["tcfg"], dense["tp"],
                                          dense["tb"])
    assert float(loss) == float(loss0)
    assert_grads_close(grads0, grads, rel=1e-6)
    calls.clear()
    with torch.no_grad():
        TM.lm_loss(cfg, dense["tp"], dense["tb"])
    assert calls == []


def test_training_forward_unbinds_stacked_leaves(dense):
    """A training forward takes each layer by one ``torch.unbind`` per
    stacked leaf (one stack in backward); a forward without grad keeps
    the ``layer_slice`` views."""
    stack = dense["tp"]["layers"]
    trees = TM.layer_trees(stack, 2)
    assert all(t["ln1"]._base is stack["ln1"] for t in trees)
    assert all(t["ln1"].grad_fn is None for t in trees)
    tracked = {k: v.detach().requires_grad_(True) if not isinstance(v, dict)
               else {kk: vv.detach().requires_grad_(True)
                     for kk, vv in v.items()} for k, v in stack.items()}
    trees = TM.layer_trees(tracked, dense["tcfg"].n_layers)
    assert len(trees) == dense["tcfg"].n_layers
    assert {type(t["attn"]["wq"].grad_fn).__name__
            for t in trees} == {"UnbindBackward0"}
    torch.testing.assert_close(trees[1]["mlp"]["w_up"],
                               stack["mlp"]["w_up"][1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro_batches", [1, 2])
def test_train_step_matches_reference(dense, micro_batches):
    jopt = JA.AdamW(lr=LR, schedule=JA.cosine_schedule(LR, 2, 10),
                    weight_decay=0.01)
    topt = TA.AdamW(lr=LR, schedule=TA.cosine_schedule(LR, 2, 10),
                    weight_decay=0.01)
    jstep = jax.jit(JS.make_train_step(dense["jcfg"], jopt,
                                       micro_batches=micro_batches))
    tstep = TS.make_train_step(dense["tcfg"], topt,
                               micro_batches=micro_batches)
    jp, jst, jm = jstep(dense["jp"], jopt.init(dense["jp"]), dense["jb"])
    tp, tst, tm = tstep(dense["tp"], topt.init(dense["tp"]), dense["tb"])
    assert set(tm) == set(jm) == {"nll", "aux", "loss", "grad_norm", "lr"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **LOSS_TOL)
    assert int(tst.step) == int(jst.step) == 1
    lr = float(jm["lr"])
    assert_step_close(jp, tp, dense["grads"], dense["jp"], lr)
    assert_grads_close(jst.mu, tst.mu)
    # the micro-batch gradients are summed in f32: f32 moments either way
    assert all(t.dtype == torch.float32 for _, t in flatten(tst.nu))


def test_micro_batches_accumulate_in_f32():
    """bf16 parameters: with one micro-batch the gradients stay bf16 (the
    clipped gradient is rounded to bf16); with two they are f32 sums."""
    cfg, _ = port_tiny_pair(vocab=64)
    cfg = cfg.replace(dtype="bfloat16", n_layers=1)
    params = TM.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (4, 16)))
    seen = []

    class Spy(TA.AdamW):
        def update(self, grads, state, params):
            seen.append({g.dtype for _, g in flatten(grads)})
            return super().update(grads, state, params)

    for m in (1, 2):
        opt = Spy(lr=1e-3)
        new, _, met = TS.make_train_step(cfg, opt, micro_batches=m)(
            params, opt.init(params), {"tokens": toks})
        assert all(t.dtype == torch.bfloat16 for _, t in flatten(new))
        assert bool(torch.isfinite(met["loss"]))
    assert seen == [{torch.bfloat16}, {torch.float32}]


# ---------------------------------------------------------------------------
# AdamW, schedule, clipping
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"a": rng.standard_normal(5).astype(np.float32),
            "layers": {"ln": rng.standard_normal((3, 4)).astype(np.float32),
                       "w": rng.standard_normal((3, 4, 6)).astype(np.float32)}}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(state_dtype):
    """Three updates of the same gradients through both optimizers: a 1-D
    leaf (no decay), a stacked 2-D norm weight and a 3-D stack (decayed);
    the second update clips (norm over ``max_grad_norm``)."""
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    grads = [jax.tree.map(lambda x, s=s: x * s, _opt_tree(rng))
             for s in (0.05, 3.0, 0.2)]
    kw = dict(lr=1e-2, weight_decay=0.1)
    jopt = JA.AdamW(**kw, schedule=JA.cosine_schedule(1e-2, 1, 3),
                    state_dtype=getattr(jnp, state_dtype))
    topt = TA.AdamW(**kw, schedule=TA.cosine_schedule(1e-2, 1, 3),
                    state_dtype=getattr(torch, state_dtype))
    jp, jst = params, jopt.init(params)
    tp = bridge.params_from_reference(params, device="cpu")
    tst = topt.init(tp)
    for g in grads:
        jp, jst, jm = jopt.update(g, jst, jp)
        tp, tst, tm = topt.update(bridge.params_from_reference(
            g, device="cpu"), tst, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **OPT_TOL)
    assert int(tst.step) == int(jst.step) == 3
    for ref, port in ((jp, tp), (jst.mu, tst.mu), (jst.nu, tst.nu)):
        r, t = flat_np(ref), flat_np(port)
        for k in r:
            np.testing.assert_allclose(t[k], r[k], **OPT_TOL)
    assert {t.dtype for _, t in flatten(tst.mu)} == {getattr(torch,
                                                             state_dtype)}
    # weight decay reaches the stacked 2-D norm weight, not the 1-D leaf
    z = TA.AdamW(lr=0.1, weight_decay=0.5)
    zp = bridge.params_from_reference(params, device="cpu")
    zero = {k: (torch.zeros_like(v) if not isinstance(v, dict) else
                {kk: torch.zeros_like(vv) for kk, vv in v.items()})
            for k, v in zp.items()}
    moved, _, _ = z.update(zero, z.init(zp), zp)
    assert torch.equal(moved["a"], zp["a"])
    torch.testing.assert_close(moved["layers"]["ln"],
                               zp["layers"]["ln"] * (1 - 0.1 * 0.5))


def test_cosine_schedule_matches_reference():
    jlr = JA.cosine_schedule(3e-3, warmup=20, total=300)
    tlr = TA.cosine_schedule(3e-3, warmup=20, total=300)
    for step in (0, 7, 20, 160, 300, 310):
        got = tlr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jlr(step)), rtol=1e-6,
                                   atol=0)
    assert float(tlr(310)) == pytest.approx(3e-4, rel=1e-6)


@pytest.mark.parametrize("max_norm", [100.0, 0.5])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(11)
    tree = _opt_tree(rng)
    jc, jn = JA.clip_by_global_norm(tree, max_norm)
    tc, tn = TA.clip_by_global_norm(
        bridge.params_from_reference(tree, device="cpu"), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
    r, t = flat_np(jc), flat_np(tc)
    for k in r:
        np.testing.assert_allclose(t[k], r[k], **OPT_TOL)
    clipped = float(tn) > max_norm
    assert clipped == (max_norm == 0.5)
    if not clipped:
        for k in r:
            np.testing.assert_array_equal(t[k], flat_np(tree)[k])


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_matches_reference_exactly(bits, dtype):
    w = np.random.default_rng(bits).standard_normal((3, 16, 8)).astype(
        np.float32)
    w[1, :, 2] = 0.0                       # an all-zero channel: scale 1
    w[0, 0, 0] = 0.5 * float(np.abs(w[0, :, 0]).max())   # a tie candidate
    ref = np.asarray(JQ.fake_quant(jnp.asarray(w, getattr(jnp, dtype)), bits)
                     .astype(jnp.float32))
    got = TQ.fake_quant(torch.as_tensor(w).to(getattr(torch, dtype)), bits)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    v = torch.ones(4)
    assert TQ.fake_quant(v, bits) is v


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_matches_reference(dense, bits):
    ref = flat_np(JQ.quantize_params(dense["jp"], bits))
    got = flat_np(TQ.quantize_params(dense["tp"], bits))
    orig = flat_np(dense["jp"])
    assert ref.keys() == got.keys()
    changed = {k for k in ref if not np.array_equal(ref[k], orig[k])}
    assert changed == {k for k in got if not np.array_equal(got[k], orig[k])}
    assert {k[-1] for k in changed} == {"wq", "wk", "wv", "wo", "w_gate",
                                       "w_up", "w_down", "unembed"}
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_speedup_factor():
    for bits in (8, 4, 16):
        assert TQ.speedup_factor(bits) == JQ.speedup_factor(bits)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _bf16_tree(dense):
    ref = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), dense["jp"])
    return ref, bridge.params_from_reference(dense["jp"], device="cpu",
                                             dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_matches_reference(dense, tmp_path, dtype):
    if dtype == "bfloat16":
        ref_tree, port_tree = _bf16_tree(dense)
    else:
        ref_tree, port_tree = dense["jp"], dense["tp"]
    ref_io.save(str(tmp_path / "ref.npz"), ref_tree)
    port_io.save(str(tmp_path / "sub" / "port.npz"), port_tree)
    with np.load(tmp_path / "ref.npz") as r, \
            np.load(tmp_path / "sub" / "port.npz") as t:
        assert sorted(r.files) == sorted(t.files)
        assert "layers||attn||wq" in t.files
        for k in r.files:
            assert t[k].dtype == r[k].dtype, k
            assert t[k].shape == r[k].shape, k
            assert t[k].tobytes() == r[k].tobytes(), k


def test_checkpoints_read_back(dense, tmp_path):
    """The reference's ``load`` reads the port's float32 file; the port's
    ``load`` reads float32 and bfloat16 files from either package."""
    port_io.save(str(tmp_path / "f32.npz"), dense["tp"])
    back = ref_io.load(str(tmp_path / "f32.npz"), dense["jp"])
    r, t = flat_np(dense["jp"]), flat_np(back)
    for k in r:
        np.testing.assert_array_equal(t[k], r[k])
    ref_bf16, port_bf16 = _bf16_tree(dense)
    ref_io.save(str(tmp_path / "ref_bf16.npz"), ref_bf16)
    port_io.save(str(tmp_path / "port_bf16.npz"), port_bf16)
    cfg = dense["tcfg"]
    bcfg = cfg.replace(dtype="bfloat16")
    for path, c, want in (("f32.npz", cfg, dense["tp"]),
                          ("ref_bf16.npz", bcfg, port_bf16),
                          ("port_bf16.npz", bcfg, port_bf16)):
        got = port_io.load(str(tmp_path / path), c, device="cpu")
        for (p, a), (q, b) in zip(flatten(got), flatten(want)):
            assert p == q and a.dtype == b.dtype
            assert torch.equal(a, b), p


def test_reference_load_fails_on_bf16_checkpoints(dense, tmp_path):
    """R7: the reference's ``load`` cannot read a bfloat16 checkpoint that
    its own ``save`` wrote (``numpy.savez`` keeps the leaves as raw V2
    records), nor the port's; the port reads both (above)."""
    ref_bf16, port_bf16 = _bf16_tree(dense)
    ref_io.save(str(tmp_path / "ref_bf16.npz"), ref_bf16)
    port_io.save(str(tmp_path / "port_bf16.npz"), port_bf16)
    for name in ("ref_bf16.npz", "port_bf16.npz"):
        with pytest.raises(ValueError, match="No cast function"):
            ref_io.load(str(tmp_path / name), ref_bf16)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_train_matches_reference(dense, monkeypatch, tmp_path):
    """Five steps of ``train`` from the reference's initial parameters:
    the same corpus, batch draws, schedule and per-step losses; the saved
    checkpoint reads back through the reference's ``load``."""
    corpus, _ = SyntheticTask(TaskSpec(vocab=64)).corpus(
        n_sequences=8, length=256, seed=0)
    kw = dict(steps=5, batch_size=4, seq_len=32, corpus=corpus, log_every=0)
    _, ref_losses = ref_train.train(dense["jcfg"], **kw)
    monkeypatch.setattr(
        port_train.M, "init_params",
        lambda cfg, seed, device=None: bridge.params_from_reference(
            dense["jp"], device=device))
    path = tmp_path / "ckpt" / "tiny-slm.npz"
    params, losses = port_train.train(dense["tcfg"], device="cpu",
                                      ckpt_path=str(path), **kw)
    np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL)
    assert losses[-1] < losses[0]
    back = flat_np(ref_io.load(str(path), dense["jp"]))
    for k, v in flat_np(params).items():
        np.testing.assert_array_equal(back[k], v)


def test_train_main_on_cpu(tmp_path, capsys):
    out = tmp_path / "tiny-llm.npz"
    port_train.main(["--device", "cpu", "--model", "tiny-llm", "--steps",
                     "2", "--batch", "2", "--seq", "16", "--out", str(out)])
    assert "training tiny-llm" in capsys.readouterr().out
    _, llm = port_tiny_pair(vocab=64)
    params = port_io.load(str(out), llm, device="cpu")
    assert params["layers"]["attn"]["wq"].shape[0] == llm.n_layers
    assert port_train.get_tiny("tiny-slm", 64).name == "tiny-slm"


# ---------------------------------------------------------------------------
# The hand-written kernels have no gradient
# ---------------------------------------------------------------------------

def test_pallas_attention_refuses_grad(dense):
    """Under grad the kernel path raises on every device (on the card a
    kernel's output has no ``grad_fn``, so a loss through it would train
    the projections before it with zero gradient); without grad it runs."""
    cfg = dense["tcfg"].replace(attn_impl="pallas")
    with pytest.raises(RuntimeError, match="no gradient"):
        TS.loss_and_grad(cfg, dense["tp"], dense["tb"])
    with torch.no_grad():
        loss, _ = TM.lm_loss(cfg, dense["tp"], dense["tb"])
    np.testing.assert_allclose(float(loss), dense["loss"], rtol=1e-4)
    q = torch.zeros((1, 2, 4, 32), requires_grad=True)
    cache = {"k": torch.zeros((2, 4, 4, 32)), "v": torch.zeros((2, 4, 4, 32)),
             "pos": torch.full((2, 4), -1, dtype=torch.int32),
             "block_tables": torch.zeros((1, 2), dtype=torch.int32)}
    pos = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        TL.paged_pallas_attention(q, cache, pos)
    with pytest.raises(RuntimeError, match="no gradient"):
        TL.pallas_attention(q, q.detach(), q.detach(), pos, pos)
