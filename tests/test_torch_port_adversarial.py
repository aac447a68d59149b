"""The port's adversarial FastSpeech2 trainers against masg_tpu's: the
`--use_clf` step (frozen GE2E discriminator, `clf_featurization` model and
ge2e) and the ganlike step (FastSpeech2 + discriminator under one optimizer,
grad_acc_step 1 and 2), as f64 trajectories with dropout off and the
speaker shuffle and label jitter injected. The f32 step through the flash
path and the CLIs are in tests/test_torch_port_adversarial_f32.py."""

import jax
import jax.numpy as jnp
import pytest
import torch

from masg_tpu.core import config as jcfg
from masg_tpu.train.state import create_train_state as jax_create_train_state
from masg_tpu.train.step import make_ganlike_train_step as jax_make_ganlike_train_step
from masg_tpu_torch.compat.from_jax import ge2e_state_dict_from_jax
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.models.ganlike import GANLike
from masg_tpu_torch.train.state import create_train_state
from masg_tpu_torch.train.step import (batch_to_device, make_ganlike_train_step,
                                       make_train_step)
from torch_port_support import (D_LAYERS, HIDDEN, METRICS, TOTAL_STEP, _to64,
                                adversarial_batches, assert_params, assert_traj,
                                jax_clf_trajectory, jax_discriminator, jax_init, jax_optimizer,
                                jax_run, jax_step, no_flax_dropout, port_discriminator,
                                port_model, tiny_config)  # noqa: F401  (a fixture)


@pytest.mark.parametrize("featurization", ["model", "ge2e"])
def test_use_clf_f64_trajectory_matches(featurization, no_flax_dropout):
    """5 `--use_clf` steps, total_step = 100: every StepMetrics field
    (dloss ≠ 0 included) within 1e-5 relative, the final FastSpeech2
    parameters and BatchNorm statistics within 1e-6; the frozen
    discriminator unchanged."""
    batches = adversarial_batches(5, seed=10)
    with jax.enable_x64(True):
        cfg_j = tiny_config(jcfg)
        model, params, bs = jax_init(cfg_j, batches[0], dtype=jnp.float64)
        params, bs = _to64(params), _to64(bs)
        jd, dparams = jax_discriminator()
        dparams = _to64(dparams)
        want, final = jax_clf_trajectory(cfg_j, batches, params, bs, dparams, jd, model,
                                         featurization)
    assert all(w["dloss"] != 0 for w in want)
    cfg = tiny_config(tcfg)
    m = port_model(cfg, params, bs, torch.float64)
    td = port_discriminator(dparams, torch.float64)
    frozen = {k: v.clone() for k, v in td.state_dict().items()}
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    step = make_train_step(m, use_clf=True, discriminator=td, total_step=TOTAL_STEP,
                           clf_featurization=featurization)
    got = []
    for b in batches:
        state, metrics = step(state, batch_to_device(b, "cpu", torch.float64))
        got.append({k: float(getattr(metrics, k)) for k in METRICS})
    assert_traj(got, want, f"--use_clf f64 trajectory, clf_featurization={featurization}")
    assert_params(m, cfg, final.params, final.batch_stats,
                  f"--use_clf f64 trajectory, clf_featurization={featurization}", atol=1e-6)
    assert all(not p.requires_grad and p.grad is None for p in td.parameters())
    assert all(torch.equal(v, frozen[k]) for k, v in td.state_dict().items())


@pytest.mark.parametrize("grad_acc_step", [1, 2])
def test_ganlike_f64_trajectory_matches(grad_acc_step, no_flax_dropout):
    """ganlike, f64, dropout off, injected reorder and label jitter: the
    StepMetrics within 1e-5 relative, the final FastSpeech2 and discriminator
    parameters within 1e-6 (masg_tpu's folded LSTM bias against the port's two
    halves), at grad_acc_step 1 and 2 (the dloss term scaled by k)."""
    batches = adversarial_batches(4 if grad_acc_step == 1 else 6, seed=20, jitter=True)
    with jax.enable_x64(True):
        cfg_j = tiny_config(jcfg, grad_acc_step=grad_acc_step)
        model, params, bs = jax_init(cfg_j, batches[0], dtype=jnp.float64)
        params, bs = _to64(params), _to64(bs)
        jd, dparams = jax_discriminator()
        dparams = _to64(dparams)
        tx = jax_optimizer(cfg_j.train.optimizer, HIDDEN, clip_subtree="model",
                           torch_lstm_bias_compat=True)
        jstate = jax_create_train_state(
            model, {"params": {"model": params, "discriminator": dparams},
                    "batch_stats": bs}, tx)
        step_fn = jax_step(jax_make_ganlike_train_step, model, discriminator=jd,
                           total_step=TOTAL_STEP, grad_acc_step=grad_acc_step)
        want, final, _ = jax_run(step_fn, jstate, batches)
    cfg = tiny_config(tcfg, grad_acc_step=grad_acc_step)
    gl = GANLike(port_model(cfg, params, bs, torch.float64),
                 port_discriminator(dparams, torch.float64))
    state = create_train_state(gl, cfg.train.optimizer, HIDDEN)
    assert state.grad_acc_step == grad_acc_step  # the step reads k from the state
    step = make_ganlike_train_step(gl, total_step=TOTAL_STEP)
    # grad_norm: the port's two LSTM biases per gate carry the same gradient,
    # which masg_tpu's one folded bias counts once; take the second copy out
    hh = []
    for layer in range(D_LAYERS):
        getattr(gl.discriminator.LSTM_stack, f"bias_hh_l{layer}").register_hook(
            lambda g: hh.append(float(g.square().sum())))
    got = []
    for b in batches:
        hh.clear()
        state, metrics = step(state, batch_to_device(b, "cpu", torch.float64))
        got.append({k: float(getattr(metrics, k)) for k in METRICS})
        assert len(hh) == D_LAYERS
        got[-1]["grad_norm"] = (got[-1]["grad_norm"] ** 2 - sum(hh)) ** 0.5
    what = f"ganlike f64 trajectory, grad_acc_step={grad_acc_step}"
    assert all(g["dloss"] != 0 for g in got)
    assert_traj(got, want, what)
    assert_params(gl.model, cfg, final.params["model"], final.batch_stats, what, atol=1e-6)
    dwant = ge2e_state_dict_from_jax(final.params["discriminator"])
    dgot = gl.discriminator.state_dict()
    derr = max(float((dgot[k] - dwant[k]).abs().max()) for k in dwant)
    print(f"[parity] {what}: final discriminator parameters, max abs err {derr:.3g}")
    assert derr <= 1e-6
    for layer in range(D_LAYERS):  # both halves of each gate's bias moved together
        torch.testing.assert_close(dgot[f"LSTM_stack.bias_ih_l{layer}"],
                                   dgot[f"LSTM_stack.bias_hh_l{layer}"], rtol=0, atol=1e-12)
