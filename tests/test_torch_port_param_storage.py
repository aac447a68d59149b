"""`--param_storage bf16|bf16_moments` in the port against masg_tpu's
`with_master_params` chain: one optimizer update on given gradients (the
master within 1e-6, the bf16 parameters exact), masg_tpu's own checks on a
30-step run (tests/test_train_step.py:237-309), and `cli.train
--param_storage` on the CPU with save and resume."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from masg_tpu.core import config as jcfg
from masg_tpu.train.optim import MasterParamsState, ScaleByAdamTorchState
from masg_tpu.train.optim import make_optimizer as jax_make_optimizer
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.models import FastSpeech2
from masg_tpu_torch.train.optim import BF16MomentAdam
from masg_tpu_torch.train.state import create_train_state
from masg_tpu_torch.train.step import batch_to_device, make_eval_step, make_train_step
from torch_port_support import make_batches, tiny_config

SHAPES = {"a": (6, 5), "b": (5,), "c": (3, 4, 2)}


def _find_adam(s):
    if isinstance(s, ScaleByAdamTorchState):
        return s
    if isinstance(s, (tuple, list)):
        for x in s:
            r = _find_adam(x)
            if r is not None:
                return r
    return None


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for k, v in values.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))


@pytest.mark.parametrize("storage", ["bf16", "bf16_moments"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_one_update_matches_with_master_params(storage, weight_decay):
    """Two updates on given bf16 gradients (the clip binding on the first):
    the f32 master within 1e-6 of masg_tpu's, the stored bf16 parameters
    exactly its, the moments stored in the mode's dtype."""
    rng = np.random.default_rng(0)
    cfg = jcfg.OptimizerConfig(warm_up_step=10, weight_decay=weight_decay, eps=1e-6)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
             for scale in (3.0, 0.05)]
    bf = lambda t: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), t)  # noqa: E731

    tx = jax_make_optimizer(cfg, 64, param_storage=storage)
    params = bf(init)
    opt_state = tx.init(params)
    for g in grads:
        upd, opt_state = tx.update(bf(g), opt_state, params)
        params = optax.apply_updates(params, upd)
    assert isinstance(opt_state, MasterParamsState)
    want_master = jax.tree.map(np.asarray, opt_state.master)
    want_params = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params)

    model = _Params(init).to(torch.bfloat16)
    state = create_train_state(model, tcfg.OptimizerConfig(warm_up_step=10,
                                                           weight_decay=weight_decay,
                                                           eps=1e-6), 64, storage)
    assert isinstance(state.optimizer, BF16MomentAdam) == (storage == "bf16_moments")
    from masg_tpu_torch.train.step import _update

    for g in grads:
        # d/dp sum(p * g) = g exactly: an update on the given gradients
        total = sum((p * torch.from_numpy(g[n]).to(torch.bfloat16)).float().sum()
                    for n, p in model.named_parameters())
        _update(state, total)
    for (n, p), m in zip(model.named_parameters(), state.master):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        np.testing.assert_allclose(m.numpy(), want_master[n], rtol=0, atol=1e-6, err_msg=n)
        assert np.array_equal(p.detach().float().numpy(), want_params[n]), n
        st = state.optimizer.state[m]
        want_dtype = torch.bfloat16 if storage == "bf16_moments" else torch.float32
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == want_dtype
    adam = _find_adam(opt_state.inner)
    for n, m in zip(SHAPES, state.master):
        st = state.optimizer.state[m]
        np.testing.assert_allclose(st["exp_avg"].float().numpy(),
                                   np.asarray(adam.mu[n], np.float32), rtol=0, atol=1e-6)
    worst = max(float(np.abs(m.numpy() - want_master[n]).max())
                for n, m in zip(SHAPES, state.master))
    print(f"[parity] param_storage={storage}, weight decay {weight_decay}: 2 updates, "
          f"master max abs err {worst:.3g} (bar 1e-6), bf16 parameters identical")


def _run(storage, steps=30):
    """masg_tpu's recipe: 30 steps on one batch, then the eval loss."""
    cfg = tiny_config(tcfg)
    cfg.train.optimizer.warm_up_step = 50
    batch = make_batches(1, seed=5, ftype=np.float32)[0]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = FastSpeech2.from_config(cfg, use_flash=True)
    if storage != "f32":
        model.to(torch.bfloat16)
    state = create_train_state(model, cfg.train.optimizer, 64, storage)
    dtype = next(model.parameters()).dtype
    db = batch_to_device(batch, "cpu", dtype)
    step = make_train_step(model)
    for i in range(steps):
        state, m = step(state, db, i)
        assert torch.isfinite(m.total), (storage, i)
    losses, _, _ = make_eval_step(model)(state, db)
    return float(losses.total), state


@pytest.fixture(scope="module")
def f32_loss():
    return _run("f32")[0]


@pytest.mark.parametrize("storage", ["bf16", "bf16_moments"])
def test_30_step_run_keeps_masg_tpu_checks(storage, f32_loss):
    """masg_tpu's own checks (tests/test_train_step.py:237-309): the
    parameters stay bf16 through 30 updates, the master is f32 within rtol
    1e-2 of them, the moments' dtype follows the mode, and the eval loss
    after the run is within 25 % of the f32 run's. The model computes in
    bf16 with no autocast (the bf16 K1-K3 on the card); PostNet's BatchNorm
    statistics stay f32 and finite."""
    loss, state = _run(storage)
    assert np.isfinite(loss)
    assert all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    assert all(m.dtype == torch.float32 for m in state.master)
    np.testing.assert_allclose(next(state.model.parameters()).float().detach().numpy(),
                               state.master[0].numpy(), rtol=1e-2)
    want = torch.bfloat16 if storage == "bf16_moments" else torch.float32
    st = state.optimizer.state[state.master[0]]
    assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == want
    bn = [b for n, b in state.model.named_buffers() if "running_" in n]
    assert bn and all(b.dtype == torch.float32 and torch.isfinite(b).all() for b in bn)
    rel = abs(loss - f32_loss) / abs(f32_loss)
    print(f"[parity] param_storage={storage}: eval loss after 30 steps {loss:.4f} against "
          f"f32's {f32_loss:.4f} (relative gap {rel:.3g}, bar 0.25)")
    assert rel < 0.25


def test_train_cli_param_storage_resumes(tmp_path):
    """`cli.train --param_storage bf16_moments --device cpu`: 4 steps, then a
    run restored at step 2 repeats steps 3-4 bit for bit; the checkpoint
    holds the f32 master, the moments stay bf16 after the restore, and a run
    with the other storage refuses the checkpoint."""
    from masg_tpu_torch.cli.train import main
    from masg_tpu_torch.core.checkpoint import CheckpointManager
    from masg_tpu_torch.core.config import load_config_dir
    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus
    from masg_tpu_torch.train.loop import build_experiment

    tiny = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                            "decoder_hidden": 64, "conv_filter_size": 128},
            "variance_predictor": {"filter_size": 64}}
    pre = write_preprocessed_corpus(str(tmp_path / "pre"), n_utts=12, n_speakers=4, n_val=4,
                                    phones=(5, 12), frames_per_phone=(1, 4))
    cfg_dir = write_config_dir(str(tmp_path / "cfg"), pre, str(tmp_path / "out"), model=tiny,
                               optimizer={"batch_size": 4, "warm_up_step": 10},
                               step={"save_step": 2})
    args = ["-c", cfg_dir, "--device", "cpu", "--param_storage", "bf16_moments"]
    state = main(args + ["--max_steps", "4"])
    assert all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    cfg = load_config_dir(cfg_dir)
    log = os.path.join(cfg.train.path.log_path, "train", "scalars.jsonl")

    def losses():
        with open(log) as f:
            return [(r["step"], r["value"]) for r in map(json.loads, f)
                    if r["tag"] == "Loss/total_loss"]

    first = dict(losses())
    resumed = main(args + ["--restore_step", "2", "--max_steps", "2"])
    second = losses()[4:]
    assert [s for s, _ in second] == [3, 4]
    assert [v for _, v in second] == [first[s] for s, _ in second]
    payload = torch.load(CheckpointManager(cfg.train.path.ckpt_path).path(2), weights_only=True)
    assert all(m.dtype == torch.float32 for m in payload["master"])
    st = resumed.optimizer.state[resumed.master[0]]
    assert st["exp_avg"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="param_storage"):
        build_experiment(cfg, restore_step=2, device="cpu")
    with pytest.raises(ValueError, match="param_storage"):
        build_experiment(cfg, param_storage="fp8", device="cpu")
