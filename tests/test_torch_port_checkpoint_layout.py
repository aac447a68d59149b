"""The port's training checkpoint in the reference's layout, which masg_tpu
and the reference read: the optimizer state keyed by position in the
reference's `named_parameters()` order (grad-less tables and bins included),
`model.*` then `discriminator.*` under ganlike. On the CPU, f64, dropout off:

- a masg_tpu run exported by `export_torch_checkpoint(opt_state=)` (ganlike:
  `export_torch_ganlike_checkpoint`) at step 2 continues masg_tpu's
  trajectory under the port's `--restore_step 2`, and a port checkpoint
  brought into masg_tpu through `import_torch_optimizer` continues the
  port's: StepMetrics within rtol 1e-5, parameters within 1e-6 (the repo's
  f64 trajectory bars);
- a `use_jdit` checkpoint's optimizer makes the round trip through
  masg_tpu's import and export unchanged;
- a reference-format `{"model", "optimizer"}` file restores (micro-step 0,
  the schedule at Adam's count);
- `masg_tpu.cli.convert_checkpoint --torch_ckpt` reads a `cli.train`
  checkpoint of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.compat.torch_fs2 import (convert_torch_fastspeech2, export_torch_checkpoint,
                                       export_torch_ganlike_checkpoint, export_torch_optimizer,
                                       import_torch_ganlike_optimizer, import_torch_optimizer,
                                       reference_param_order)
from masg_tpu.core import config as jcfg
from masg_tpu.train.loop import convert_torch_ge2e
from masg_tpu.train.optim import make_optimizer as jax_make_optimizer
from masg_tpu.train.state import create_train_state as jax_create_train_state
from masg_tpu.train.step import make_ganlike_train_step as jax_make_ganlike_train_step
from masg_tpu.train.step import make_train_step as jax_make_train_step
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.core.checkpoint import CheckpointManager
from masg_tpu_torch.models.ganlike import GANLike
from masg_tpu_torch.train.state import create_train_state
from masg_tpu_torch.train.step import batch_to_device, make_ganlike_train_step, make_train_step
from torch_port_support import (D_LAYERS, HIDDEN, METRICS, TOTAL_STEP, _np, _to64,
                                adversarial_batches, assert_params, assert_traj,
                                jax_discriminator, jax_init, jax_optimizer, jax_run, jax_step,
                                make_batches, no_flax_dropout, port_discriminator, port_model,
                                tiny_config)  # noqa: F401  (a fixture)


def _jax_side(variant, batches):
    """masg_tpu's model, initial variables, its jitted step, the optimizer,
    and for ganlike its discriminator (module, params)."""
    cfg_j = tiny_config(jcfg)
    model, params, bs = jax_init(cfg_j, batches[0], dtype=jnp.float64)
    params, bs = _to64(params), _to64(bs)
    if variant == "plain":
        tx = jax_optimizer(cfg_j.train.optimizer, HIDDEN)
        return cfg_j, model, params, bs, jax_step(jax_make_train_step, model), tx, None
    jd, dparams = jax_discriminator()
    tx = jax_optimizer(cfg_j.train.optimizer, HIDDEN, clip_subtree="model",
                       torch_lstm_bias_compat=True)
    step = jax_step(jax_make_ganlike_train_step, model, discriminator=jd,
                    total_step=TOTAL_STEP)
    return cfg_j, model, {"model": params, "discriminator": _to64(dparams)}, bs, step, tx, jd


def _jax_run(step_fn, jstate, batches, first=0):
    traj, final, _ = jax_run(step_fn, jstate, batches, first=first)
    return traj, final


def _port_state(variant, cfg, params, bs):
    if variant == "plain":
        m = port_model(cfg, params, bs, torch.float64)
        return create_train_state(m, cfg.train.optimizer, HIDDEN), make_train_step(m)
    gl = GANLike(port_model(cfg, params["model"], bs, torch.float64),
                 port_discriminator(params["discriminator"], torch.float64))
    return (create_train_state(gl, cfg.train.optimizer, HIDDEN),
            make_ganlike_train_step(gl, total_step=TOTAL_STEP))


def _port_run(state, step, batches):
    """Steps on the port; ganlike's grad_norm without the second LSTM bias
    copy, which masg_tpu's one folded bias counts once."""
    hh = []
    if state.discriminator is not None:
        for layer in range(D_LAYERS):
            getattr(state.discriminator.LSTM_stack, f"bias_hh_l{layer}").register_hook(
                lambda g: hh.append(float(g.square().sum())))
    traj = []
    for b in batches:
        hh.clear()
        state, m = step(state, batch_to_device(b, "cpu", torch.float64))
        traj.append({k: float(getattr(m, k)) for k in METRICS})
        traj[-1]["grad_norm"] = (traj[-1]["grad_norm"] ** 2 - sum(hh)) ** 0.5
    return traj


def _to_torch(tree):
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in tree.items()}


def _assert_final(state, cfg, params, bs, what):
    fs2_params = params if state.discriminator is None else params["model"]
    assert_params(state.fs2, cfg, fs2_params, bs, what)
    if state.discriminator is not None:
        from masg_tpu_torch.compat.from_jax import ge2e_state_dict_from_jax

        want = ge2e_state_dict_from_jax(params["discriminator"])
        got = state.discriminator.state_dict()
        assert max(float((got[k] - want[k]).abs().max()) for k in want) <= 1e-6, what


@pytest.mark.parametrize("variant", ["plain", "ganlike"])
def test_checkpoints_move_between_masg_tpu_and_the_port(variant, no_flax_dropout, tmp_path):
    batches = (make_batches(4, seed=30) if variant == "plain"
               else adversarial_batches(4, seed=31, jitter=True))
    cfg = tiny_config(tcfg)
    with jax.enable_x64(True):
        cfg_j, model, params, bs, step_fn, tx, jd = _jax_side(variant, batches)
        jstate0 = jax_create_train_state(model, {"params": params, "batch_stats": bs}, tx)
        want2, after2 = _jax_run(step_fn, jstate0, batches[:2])
        want34, final = _jax_run(step_fn, after2, batches[2:], first=2)

    # masg_tpu -> the port: its export at step 2, the port's --restore_step 2
    p2, bs2, opt2 = _np(after2.params), _np(after2.batch_stats), _np(after2.opt_state)
    if variant == "plain":
        ckpt = export_torch_checkpoint(p2, bs2, cfg_j, opt_state=opt2)
    else:
        ckpt = export_torch_ganlike_checkpoint(p2, bs2, cfg_j, opt_state=opt2,
                                               disc_n_layers=D_LAYERS)
    payload = {k: _to_torch(v) for k, v in ckpt.items() if k != "optimizer"}
    payload["optimizer"] = ckpt["optimizer"]
    mgr = CheckpointManager(str(tmp_path / "from_masg_tpu"))
    torch.save(payload, mgr.path(2))
    state, step = _port_state(variant, cfg, params, bs)
    state = mgr.restore(2, state)
    assert state.step == 2 and state.scheduler.last_epoch == 2 and state.micro_step == 0
    got34 = _port_run(state, step, batches[2:])
    what = f"{variant}: masg_tpu's step-2 export, continued by the port"
    assert_traj(got34, want34, what)
    _assert_final(state, cfg, final.params, final.batch_stats, what)

    # the port -> masg_tpu: the port's own checkpoint at step 2, imported
    state, step = _port_state(variant, cfg, params, bs)
    port2 = _port_run(state, step, batches[:2])
    assert_traj(port2, want2, f"{variant}: the port's first 2 steps")
    mine = CheckpointManager(str(tmp_path / "port"))
    mine.save(2, state)
    port34 = _port_run(state, step, batches[2:])
    saved = torch.load(mine.path(2), weights_only=True)
    sd = {k: v.numpy() for k, v in saved["model"].items()}
    with jax.enable_x64(True):
        jparams, jbs = convert_torch_fastspeech2(sd, 2, 2)
        if variant == "plain":
            jstate = jax_create_train_state(model, {"params": _to64(jparams),
                                                    "batch_stats": _to64(jbs)}, tx)
            opt = import_torch_optimizer(jstate.opt_state, saved["optimizer"],
                                         param_names=reference_param_order(2, 2))
        else:
            dp = convert_torch_ge2e({k: v.numpy() for k, v in saved["discriminator"].items()},
                                    jd)
            jstate = jax_create_train_state(
                model, {"params": {"model": _to64(jparams), "discriminator": _to64(dp)},
                        "batch_stats": _to64(jbs)}, tx)
            opt = import_torch_ganlike_optimizer(jstate.opt_state, saved["optimizer"], cfg_j,
                                                 jd)
        jstate = jstate.replace(opt_state=jax.tree.map(jnp.asarray, opt), step=2)
        jax34, _ = _jax_run(step_fn, jstate, batches[2:], first=2)
    assert_traj(jax34, port34, f"{variant}: the port's step-2 checkpoint, continued by "
                               f"masg_tpu")


def test_jdit_optimizer_round_trips_through_masg_tpu(tmp_path):
    """A `use_jdit` run's optimizer, in the reference order with the teacher's
    names, read by masg_tpu's import and written back by its export, restores
    in the port to the same Adam state."""
    from masg_tpu_torch.compat.torch_order import reference_param_order as port_order
    from masg_tpu_torch.models import FastSpeech2

    cfg = tiny_config(tcfg)
    cfg.model.jdit.use_jdit = True
    for k, v in dict(attention_rnn_dim=32, decoder_rnn_dim=24, prenet_hidden=16,
                     attention_dim=16, location_filters=8, location_kernel=5).items():
        setattr(cfg.model.jdit, k, v)
    torch.manual_seed(0)
    m = FastSpeech2.from_config(cfg, use_flash=False).double()
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    step = make_train_step(m, use_jdit=True)
    for b in make_batches(2, seed=33):
        state, _ = step(state, batch_to_device(b, "cpu", torch.float64), 0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    saved = torch.load(mgr.path(2), weights_only=True)
    names = port_order(2, 2, use_jdit=True)
    assert names == reference_param_order(2, 2, use_jdit=True)
    assert saved["optimizer"]["param_groups"][0]["params"] == list(range(len(names)))
    assert sorted(saved["optimizer"]["state"]) == [
        i for i, n in enumerate(names) if "position_enc" not in n and "_bins" not in n]

    # masg_tpu reads the moments by name and writes them back in its order
    cfg_j = tiny_config(jcfg)
    cfg_j.model.jdit.use_jdit = True
    for k in ("attention_rnn_dim", "decoder_rnn_dim", "prenet_hidden", "attention_dim",
              "location_filters", "location_kernel"):
        setattr(cfg_j.model.jdit, k, getattr(cfg.model.jdit, k))
    with jax.enable_x64(True):
        sd = {k: v.numpy() for k, v in saved["model"].items()}
        jparams, _ = convert_torch_fastspeech2(sd, 2, 2)
        tx = jax_make_optimizer(cfg_j.train.optimizer, HIDDEN, torch_lstm_bias_compat=True)
        opt = import_torch_optimizer(tx.init(jparams), saved["optimizer"], param_names=names)
        back = export_torch_optimizer(_np(opt), param_names=names, betas=(0.9, 0.98),
                                      eps=cfg.train.optimizer.eps)
    fresh = create_train_state(FastSpeech2.from_config(cfg, use_flash=False).double(),
                               cfg.train.optimizer, HIDDEN)
    torch.save({"model": saved["model"], "optimizer": back}, mgr.path(3))
    fresh = mgr.restore(3, fresh)
    a, b = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert a.keys() == b.keys() and fresh.scheduler.last_epoch == 2
    for i in a:
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(b[i][k], a[i][k], rtol=1e-12, atol=1e-15)


def test_reference_format_file_restores(tmp_path):
    """`{"model", "optimizer"}` only, as the reference writes it (no
    scheduler, micro-step, accumulated gradient): no KeyError; micro-step 0,
    the schedule at Adam's count, the moments in place."""
    torch.manual_seed(0)
    cfg = tiny_config(tcfg)
    from masg_tpu_torch.models import FastSpeech2

    m = FastSpeech2.from_config(cfg, use_flash=False)
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    step = make_train_step(m)
    for b in make_batches(3, seed=34, ftype=np.float32):
        state, _ = step(state, batch_to_device(b, "cpu", torch.float32), 0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    full = torch.load(mgr.path(3), weights_only=True)
    torch.save({"model": full["model"], "optimizer": full["optimizer"]}, mgr.path(4))
    fresh = create_train_state(FastSpeech2.from_config(cfg, use_flash=False),
                               cfg.train.optimizer, HIDDEN)
    fresh = mgr.restore(4, fresh)
    assert fresh.step == 4 and fresh.micro_step == 0 and fresh.scheduler.last_epoch == 3
    assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    a, b = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i]["exp_avg"], b[i]["exp_avg"]) for i in a)


def test_masg_tpu_convert_checkpoint_reads_a_port_checkpoint(tmp_path):
    """`masg_tpu.cli.convert_checkpoint --torch_ckpt` on the port's
    `cli.train` step-2 checkpoint: weights and Adam moments into masg_tpu's
    orbax checkpoint (before the reference layout: "axes don't match")."""
    import sys

    from masg_tpu.cli.convert_checkpoint import main as convert
    from masg_tpu_torch.cli.train import main as train
    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus

    pre = write_preprocessed_corpus(str(tmp_path / "pre"), n_utts=8, n_speakers=2, n_val=4,
                                    phones=(5, 10), frames_per_phone=(1, 3))
    tiny = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                            "decoder_hidden": 64, "conv_filter_size": 128},
            "variance_predictor": {"filter_size": 64}}
    cfg_dir = write_config_dir(str(tmp_path / "cfg"), pre, str(tmp_path / "out"), model=tiny,
                               optimizer={"batch_size": 4},
                               step={"save_step": 2, "synth_step": 1000, "val_step": 1000})
    with pytest.MonkeyPatch.context() as mp:
        if "tensorflow" not in sys.modules:  # tensorboard's stub: TF takes ~14 s to import
            mp.setitem(sys.modules, "tensorflow", None)
        train(["-c", cfg_dir, "--device", "cpu", "--max_steps", "2"])
    ckpt = tmp_path / "out" / "ckpt" / "2.pth.tar"
    convert(["-c", cfg_dir, "--torch_ckpt", str(ckpt), "--step", "2",
             "--out", str(tmp_path / "orbax")])
    assert (tmp_path / "orbax" / "2").exists()
