"""The loss and its gradients for every reference config's reduced form,
port against reference, on the CPU in float32 with the reference's own
parameters (through ``repro_torch.bridge``) and the aux inputs that
``tests/test_models.py:aux_for`` draws.  The vlm's cross-layer gates are
set to 0.5 in both (at init they are 0 and the cross layers do nothing).

This covers the MoE experts' products, which autograd now follows
(qwen3-moe, llama4), and the Mamba2 scan under ``attn_impl="pallas"``:
under grad ``mamba_block`` takes the plain scan, the reference's own
training path, so mamba2 trains there and equals the reference.
Tolerances as in ``tests/test_torch_train.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as port_ssd
from repro_torch.models import model as TM
from repro_torch.models import steps as TS
from test_models import aux_for
from test_torch_train import LOSS_TOL, assert_grads_close

B, T = 2, 32
GATE = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU shapes: one intra-op thread is enough, and idle spinning
    worker threads would slow the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_case(name, impl="blocked"):
    """Both packages' reduced configs under ``impl``, the reference's
    parameters (vlm gates 0.5), a batch with its aux input, and the
    reference's loss, metrics and gradients."""
    jcfg = ref_get_config(name).reduced().replace(attn_impl=impl)
    tcfg = get_config(name).reduced().replace(attn_impl=impl)
    jp = jax.tree.map(np.array, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    if jcfg.family == "vlm":
        for key in ("gate_attn", "gate_ffn"):
            jp["cross_layers"][key][:] = GATE
    key = jax.random.PRNGKey(1)
    jb = {"tokens": jax.random.randint(key, (B, T), 0, jcfg.vocab)}
    jb.update(aux_for(jcfg, B, key))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(jcfg, p, jb), has_aux=True))(jp)
    tb = {k: torch.as_tensor(np.array(v)) for k, v in jb.items()}
    return dict(tcfg=tcfg, tp=bridge.params_from_reference(jp, device="cpu"),
                tb=tb, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, grads))


def check_case(c):
    loss, metrics = TM.lm_loss(c["tcfg"], c["tp"], c["tb"])
    np.testing.assert_allclose(float(loss), c["loss"], **LOSS_TOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(metrics[k]), c["metrics"][k],
                                   **LOSS_TOL)
    (gloss, _), grads = TS.loss_and_grad(c["tcfg"], c["tp"], c["tb"])
    assert float(gloss) == float(loss)
    assert_grads_close(c["grads"], grads)
    return metrics, grads


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_loss_and_grads_match_reference(name):
    metrics, grads = check_case(family_case(name))
    cfg = get_config(name)
    if cfg.family == "moe":
        # the load-balance loss is live and every expert weight is reached
        assert float(metrics["aux"]) > 0
        layers = grads.get("layers") or grads["moe_layers"]
        assert float(layers["moe"]["w_down"].abs().amax()) > 0
    if cfg.family == "vlm":
        assert float(grads["cross_layers"]["attn"]["wq"].abs().amax()) > 0
        assert float(grads["vision_proj"].abs().amax()) > 0
    if cfg.family == "audio":
        assert float(grads["enc_layers"]["attn"]["wq"].abs().amax()) > 0


def test_mamba2_trains_under_pallas_through_the_plain_scan(monkeypatch):
    """Under grad the scan kernel is never asked (it would refuse): the
    plain scan runs, and the loss and gradients equal the reference's."""
    called = []
    real = port_ssd.ssd_scan_ref

    def spy(*a, **k):
        called.append(a[0].requires_grad)
        return real(*a, **k)

    monkeypatch.setattr("repro_torch.models.layers.ssd_scan_ref", spy)
    c = family_case("mamba2-2.7b", impl="pallas")
    check_case(c)
    assert called and all(called)
    x = torch.zeros((1, 8, 2, 4), requires_grad=True)
    dt, A = torch.ones((1, 8, 2)), -torch.ones(2)
    Bm = Cm = torch.zeros((1, 8, 4))
    with pytest.raises(RuntimeError, match="no gradient"):
        port_ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=4)
    with torch.no_grad():
        y, _ = port_ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=4)
    assert y.shape == x.shape


def test_remat_matches_across_families():
    """``remat=True`` (each layer recomputed in backward; the encoder's
    and the vlm's cross layers too) gives the loss and gradients of the
    forward without it."""
    for name in ("llama-3.2-vision-90b", "whisper-medium", "zamba2-2.7b",
                 "llama4-maverick-400b-a17b"):
        cfg = get_config(name).reduced()
        params = TM.init_params(cfg, 0, device="cpu")
        rng = np.random.default_rng(2)
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                        (B, T)))}
        if cfg.family in TM.AUX_INPUTS:
            src = (cfg.n_image_tokens, cfg.vision_dim) \
                if cfg.family == "vlm" else (cfg.n_audio_frames, cfg.d_model)
            batch[TM.AUX_INPUTS[cfg.family]] = torch.as_tensor(
                rng.standard_normal((B, *src)).astype(np.float32))
        (l0, _), g0 = TS.loss_and_grad(cfg, params, batch)
        (l1, _), g1 = TS.loss_and_grad(cfg.replace(remat=True), params, batch)
        assert float(l1) == float(l0), name
        assert_grads_close(g0, g1, rel=1e-6)
