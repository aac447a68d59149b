"""The port's plain FastSpeech2 train step (masg_tpu_torch.train) against
masg_tpu's: losses and the Noam schedule, f64 trajectories with dropout off
(plain and with grad accumulation), a resume from masg_tpu's Adam state, and
an f32 step through the flash path (masg_tpu's Pallas kernels in interpret
mode, the port's plain K1-K3)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.core import config as jcfg
from masg_tpu.models.loss import fastspeech2_loss as jax_fastspeech2_loss
from masg_tpu.models.loss import speaker_prior_log_prob as jax_speaker_prior_log_prob
from masg_tpu.train.optim import ScaleByAdamTorchState
from masg_tpu.train.optim import noam_schedule as jax_noam_schedule
from masg_tpu.train.step import make_train_step as jax_make_train_step
from masg_tpu_torch.compat.from_jax import adam_state_from_jax, fs2_state_dict_from_jax
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.models import FastSpeech2
from masg_tpu_torch.models.loss import fastspeech2_loss, speaker_prior_log_prob
from masg_tpu_torch.ops.gmm import DiagGMM
from masg_tpu_torch.train.optim import noam_schedule, set_schedule_count
from masg_tpu_torch.train.state import create_train_state
from masg_tpu_torch.train.step import batch_to_device, make_train_step
from torch_port_support import (HIDDEN, METRICS, _np, _to64, assert_params, assert_traj,
                                jax_init, jax_trajectory, make_batches,
                                no_flax_dropout, port_model,
                                tiny_config)  # noqa: F401  (a fixture)


def port_trajectory(state, batches, dtype):
    step = make_train_step(state.model)
    traj = []
    for b in batches:
        state, m = step(state, batch_to_device(b, "cpu", dtype))
        traj.append({k: float(getattr(m, k)) for k in METRICS})
    return traj


@pytest.fixture(scope="module")
def f64_run(no_flax_dropout):
    """masg_tpu's 5-step f64 trajectory, its initial weights and its state after 2 steps."""
    cfg = tiny_config(jcfg)
    batches = make_batches(5, seed=0)
    with jax.enable_x64(True):
        model, params, bs = jax_init(cfg, batches[0], dtype=jnp.float64)
        params, bs = _to64(params), _to64(bs)
        traj, final, after2 = jax_trajectory(cfg, batches, params, bs, model, keep_after=2)
    return dict(batches=batches, params=params, bs=bs, traj=traj, final=final,
                after2=after2)


def test_loss_and_prior_match_on_identical_outputs():
    rng = np.random.default_rng(3)
    b, length, t, d, k = 3, 7, 12, 8, 3
    src_pad = np.arange(length)[None, :] >= np.array([7, 4, 1])[:, None]
    mel_pad = np.arange(t)[None, :] >= np.array([12, 9, 0])[:, None]
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    fields = dict(mel=f(b, t, 80), postnet_mel=f(b, t, 80), pitch_prediction=f(b, length),
                  energy_prediction=f(b, length), log_duration_prediction=f(b, length),
                  duration_rounded=rng.integers(0, 5, size=(b, length)).astype(np.int32),
                  src_pad_mask=src_pad, mel_pad_mask=mel_pad,
                  src_len=np.array([7, 4, 1], np.int32), mel_len=np.array([12, 9, 0], np.int32))
    targets = (f(b, t + 3, 80), f(b, length), f(b, length),
               rng.integers(0, 6, size=(b, length)).astype(np.int32))
    gmm = (np.abs(f(b, k)) + 0.1, f(b, k, d), np.abs(f(b, k, d)) + 0.2)
    gmm = (gmm[0] / gmm[0].sum(-1, keepdims=True),) + gmm[1:]
    emb = f(b, d)

    from masg_tpu.models.fastspeech2 import FS2Output as JaxOut
    from masg_tpu.ops.gmm import DiagGMM as JaxGMM
    from masg_tpu_torch.models.fastspeech2 import FS2Output

    want = jax_fastspeech2_loss(JaxOut(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                *(jnp.asarray(x) for x in targets))
    got = fastspeech2_loss(FS2Output(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                           *(torch.from_numpy(x) for x in targets))
    want_p = jax_speaker_prior_log_prob(jnp.asarray(emb), JaxGMM(*map(jnp.asarray, gmm)))
    got_p = speaker_prior_log_prob(torch.from_numpy(emb), DiagGMM(*map(torch.from_numpy, gmm)))
    for g, w in zip(list(got) + [got_p], list(want) + [want_p]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)


def test_speaker_prior_detaches_the_embedding():
    emb = torch.randn(2, 4, requires_grad=True)
    mu = torch.randn(2, 3, 4, requires_grad=True)
    gmm = DiagGMM(torch.full((2, 3), 1 / 3), mu, torch.ones(2, 3, 4))
    speaker_prior_log_prob(emb, gmm).backward()
    assert emb.grad is None and mu.grad is not None


def test_noam_schedule_matches():
    sched = noam_schedule(256, 4, anneal_steps=(6, 8), anneal_rate=0.3)
    with jax.enable_x64(True):
        jsched = jax_noam_schedule(256, 4, anneal_steps=(6, 8), anneal_rate=0.3)
        want = [float(jsched(c)) for c in range(11)]
    got = [sched(c) for c in range(11)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[3] == max(got)  # step 4 ends the warm-up
    assert math.isclose(got[6], got[5] * 0.3 * math.sqrt(6 / 7))  # first anneal past step 6


def test_f64_trajectory_matches(f64_run):
    """5 steps from the same weights, dropout off: every StepMetrics field and
    the final parameters and BatchNorm statistics at masg_tpu's torch-parity
    bars (tests/test_torch_train_parity.py)."""
    cfg = tiny_config(tcfg)
    m = port_model(cfg, f64_run["params"], f64_run["bs"], torch.float64)
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    traj = port_trajectory(state, f64_run["batches"], torch.float64)
    assert_traj(traj, f64_run["traj"], "f64 trajectory")
    final = f64_run["final"]
    assert_params(m, cfg, final.params, final.batch_stats, "f64 trajectory")


def test_f64_trajectory_grad_accumulation_matches(no_flax_dropout):
    """grad_acc_step = 2: the mean of two micro-batch gradients, one clip and
    one update (and one schedule step) every two micro-batches."""
    batches = make_batches(6, seed=1)
    with jax.enable_x64(True):
        cfg_j = tiny_config(jcfg, grad_acc_step=2)
        model, params, bs = jax_init(cfg_j, batches[0], dtype=jnp.float64)
        params, bs = _to64(params), _to64(bs)
        want, final, _ = jax_trajectory(cfg_j, batches, params, bs, model)
    cfg = tiny_config(tcfg, grad_acc_step=2)
    m = port_model(cfg, params, bs, torch.float64)
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    traj = port_trajectory(state, batches, torch.float64)
    assert state.scheduler.last_epoch == 3 and state.micro_step == 0
    assert_traj(traj, want, "f64 trajectory, grad_acc_step=2")
    assert_params(m, cfg, final.params, final.batch_stats, "f64 trajectory, grad_acc_step=2")


def test_resume_from_masg_tpu_adam_state(f64_run):
    """masg_tpu's state after 2 steps (weights, BatchNorm statistics, Adam
    moments, count) carried over: the port's steps 3-5 are masg_tpu's."""
    cfg = tiny_config(tcfg)
    after2 = f64_run["after2"]
    m = port_model(cfg, _np(after2.params), _np(after2.batch_stats), torch.float64)
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    adam = next(s for s in after2.opt_state if isinstance(s, ScaleByAdamTorchState))
    state.optimizer.load_state_dict(
        adam_state_from_jax(adam.count, _np(adam.mu), _np(adam.nu), m, state.optimizer, cfg))
    set_schedule_count(state.scheduler, int(adam.count))
    traj = port_trajectory(state, f64_run["batches"][2:], torch.float64)
    assert_traj(traj, f64_run["traj"][2:], "resume from masg_tpu's Adam state")
    final = f64_run["final"]
    assert_params(m, cfg, final.params, final.batch_stats, "resume from masg_tpu's Adam state")


def test_f32_flash_step_matches(no_flax_dropout):
    """f32 through the flash path: masg_tpu's Pallas K1-K3 in interpret mode
    against the port's plain K1-K3. One step's gradients within masg_tpu's
    model-gradient-with-flash bar (2e-3), then 3 steps of losses within 1e-4.
    masg_tpu's gradient is taken under `jax.jit`, as its train step takes it;
    that moves it at most 4.8e-7 from an eager `jax.grad`, against the 2e-3
    bar."""
    batches = make_batches(3, seed=2, ftype=np.float32)
    cfg_j = tiny_config(jcfg)
    model, params, bs = jax_init(cfg_j, batches[0], use_flash=True)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    grads, _ = jax.jit(jax.grad(jax_make_train_step(model).loss_fn, has_aux=True))(
        params, bs, jb, jax.random.PRNGKey(0), 0.0)
    want_g = fs2_state_dict_from_jax(_np(grads), None, tcfg_tiny := tiny_config(tcfg))

    m = port_model(tcfg_tiny, params, bs, torch.float32, use_flash=True)
    state = create_train_state(m, tcfg_tiny.train.optimizer, HIDDEN)
    total, *_ = make_train_step(m).loss_fn(m, batch_to_device(batches[0], "cpu", torch.float32))
    total.backward()
    errs = {n: float((p.grad - want_g[n]).abs().max()) for n, p in m.named_parameters()}
    print(f"[parity] f32 flash-path gradients: max abs err {max(errs.values()):.3g} "
          f"(bar 2e-3)")
    assert max(errs.values()) <= 2e-3, sorted(errs.items(), key=lambda x: -x[1])[:3]
    m.zero_grad(set_to_none=True)

    want, _, _ = jax_trajectory(cfg_j, batches, params, bs, model)
    got = port_trajectory(state, batches, torch.float32)
    keys = [k for k in METRICS if k not in ("dloss", "grad_norm")]
    worst = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want) for k in keys)
    print(f"[parity] f32 flash-path trajectory: 3 steps, largest relative loss err {worst:.3g}")
    assert worst <= 1e-4


def test_train_mode_dropout_sites_and_rates_match():
    """One train-mode forward draws dropout at the same sites with the same
    rates as masg_tpu's: after `fc` and in the FFN of every FFT block, twice
    in each variance predictor, after every PostNet conv. masg_tpu's sites
    are read off a trace of its loss (`jax.eval_shape`), which calls every
    Dropout as a run does: the same 19 sites and rates as an eager call."""
    import flax.linen as fnn

    batch = make_batches(1, seed=4, ftype=np.float32)[0]
    jax_rates, port_rates = [], []

    def record(self, x, deterministic=None, rng=None):
        assert deterministic is False
        jax_rates.append(self.rate)
        return x

    model, params, bs = jax_init(tiny_config(jcfg), batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", record)
        jax.eval_shape(jax_make_train_step(model).loss_fn, params, bs,
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0), 0.0)
    fresh = FastSpeech2.from_config(tiny_config(tcfg))
    hooks = [mod.register_forward_hook(lambda mod, i, o: port_rates.append(mod.p))
             for mod in fresh.modules() if isinstance(mod, torch.nn.Dropout)]
    make_train_step(fresh).loss_fn(fresh, batch_to_device(batch, "cpu", torch.float32))
    for h in hooks:
        h.remove()
    assert sorted(port_rates) == sorted(jax_rates)
    assert len(port_rates) == 4 * 2 + 3 * 2 + 5
