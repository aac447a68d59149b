"""The port's adversarial FastSpeech2 trainers in f32 against masg_tpu's: the
`--use_clf` step through the flash path (masg_tpu's Pallas kernels in
interpret mode, the port's plain K1-K3), and `cli.train --use_clf` /
`cli.train_ganlike` on the CPU with save and resume. The f64 trajectories
are in tests/test_torch_port_adversarial.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.core import config as jcfg
from masg_tpu.train.step import make_train_step as jax_make_train_step
from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.models.ganlike import GANLike
from masg_tpu_torch.train.state import create_train_state
from masg_tpu_torch.train.step import batch_to_device, make_train_step
from torch_port_support import (HIDDEN, METRICS, TOTAL_STEP, _np, adversarial_batches,
                                jax_clf_trajectory, jax_discriminator, jax_init,
                                no_flax_dropout, port_discriminator, port_model,
                                tiny_config)  # noqa: F401  (a fixture)


def test_f32_flash_use_clf_step_matches(no_flax_dropout):
    """f32 `--use_clf` through the flash path: masg_tpu's Pallas K1-K3 in
    interpret mode against the port's plain K1-K3. One step's gradients within
    2e-3, then 3 steps of losses (dloss included) within 1e-4 relative.
    masg_tpu's gradient is taken under `jax.jit`, as its train step takes it;
    that moves it at most 4.8e-7 from an eager `jax.grad`, against the 2e-3
    bar."""
    batches = adversarial_batches(3, seed=30, ftype=np.float32)
    cfg_j = tiny_config(jcfg)
    model, params, bs = jax_init(cfg_j, batches[0], use_flash=True)
    jd, dparams = jax_discriminator(jnp.float32)
    jstep = jax_make_train_step(model, use_clf=True, discriminator=jd,
                                discriminator_params=dparams, total_step=TOTAL_STEP)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    grads, _ = jax.jit(jax.grad(jstep.loss_fn, has_aux=True))(
        params, bs, jb, jax.random.PRNGKey(0), jnp.float32(0.0))
    cfg = tiny_config(tcfg)
    want_g = fs2_state_dict_from_jax(_np(grads), None, cfg)
    m = port_model(cfg, params, bs, torch.float32, use_flash=True)
    td = port_discriminator(dparams, torch.float32)
    step = make_train_step(m, use_clf=True, discriminator=td, total_step=TOTAL_STEP)
    total, *_ = step.loss_fn(m, batch_to_device(batches[0], "cpu", torch.float32), 0)
    total.backward()
    errs = {n: float((p.grad - want_g[n]).abs().max()) for n, p in m.named_parameters()}
    print(f"[parity] f32 flash-path --use_clf gradients: max abs err "
          f"{max(errs.values()):.3g} (bar 2e-3)")
    assert max(errs.values()) <= 2e-3, sorted(errs.items(), key=lambda x: -x[1])[:3]
    m.zero_grad(set_to_none=True)

    want, _ = jax_clf_trajectory(cfg_j, batches, params, bs, dparams, jd, model, "model")
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    got = []
    for b in batches:
        state, metrics = step(state, batch_to_device(b, "cpu", torch.float32))
        got.append({k: float(getattr(metrics, k)) for k in METRICS})
    keys = [k for k in METRICS if k != "grad_norm"]
    worst = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want) for k in keys)
    print(f"[parity] f32 flash-path --use_clf trajectory: 3 steps, largest relative loss "
          f"err {worst:.3g} (bar 1e-4)")
    assert worst <= 1e-4


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

TINY = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                        "decoder_hidden": 64, "conv_filter_size": 128},
        "variance_predictor": {"filter_size": 64}, "discriminator": {"hidden": 32}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from masg_tpu_torch.data.synthetic import write_preprocessed_corpus

    root = tmp_path_factory.mktemp("adv")
    pre = write_preprocessed_corpus(str(root / "pre"), n_utts=12, n_speakers=4, n_val=4,
                                    phones=(5, 12), frames_per_phone=(1, 4))
    return root, pre


@pytest.fixture(scope="module")
def ge2e_ckpt(tmp_path_factory):
    """A GE2E checkpoint from `cli.train_speech_embedder` (1 epoch, CPU)."""
    from masg_tpu_torch.cli.train_speech_embedder import main

    root = tmp_path_factory.mktemp("ge2e")
    rng = np.random.default_rng(0)
    for s in range(4):
        np.save(root / f"synth_s{s}_{'MF'[s % 2]}_{'ja' if s < 2 else 'en'}.npy",
                rng.normal(size=(3, 80, 150)).astype(np.float32))
    main(["--data_path", str(root), "--datasets", "SYNTH", "--out_dir", str(root / "out"),
          "-N", "4", "-M", "2", "--epochs", "1", "--device", "cpu"])
    return str(root / "out" / "final_epoch_1.pth")


def _config(corpus, name, **train):
    from masg_tpu_torch.data.synthetic import write_config_dir

    root, pre = corpus
    return write_config_dir(str(root / name / "cfg"), pre, str(root / name / "out"),
                            model=TINY, optimizer={"batch_size": 4, "warm_up_step": 10},
                            step={"save_step": 2}, train=train)


def _losses(cfg_dir, tag="Loss/total_loss"):
    from masg_tpu_torch.core.config import load_config_dir

    cfg = load_config_dir(cfg_dir)
    with open(os.path.join(cfg.train.path.log_path, "train", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]


def _resumes(cli, cfg_dir, extra=()):
    """4 steps (dropout on), then a run restored at step 2: steps 3-4 repeat
    their total and adversarial losses bit for bit. Returns the first state."""
    state = cli(["-c", cfg_dir, "--device", "cpu", "--max_steps", "4", *extra])
    first = {tag: dict(_losses(cfg_dir, tag)) for tag in ("Loss/total_loss", "Loss/language_classification_loss")}
    assert sorted(first["Loss/total_loss"]) == [1, 2, 3, 4]
    cli(["-c", cfg_dir, "--device", "cpu", "--restore_step", "2", "--max_steps", "2", *extra])
    for tag, want in first.items():
        second = _losses(cfg_dir, tag)[4:]
        assert [s for s, _ in second] == [3, 4], (tag, second)
        assert [v for _, v in second] == [want[s] for s, _ in second], tag
    assert all(v != 0 for v in first["Loss/language_classification_loss"].values())
    return state


@pytest.mark.parametrize("featurization", ["model", "ge2e"])
def test_train_cli_use_clf_resumes(corpus, ge2e_ckpt, featurization):
    from masg_tpu_torch.cli.train import main
    from masg_tpu_torch.core.checkpoint import CheckpointManager
    from masg_tpu_torch.core.config import load_config_dir
    from masg_tpu_torch.train.loop import build_experiment

    cfg_dir = _config(corpus, f"clf_{featurization}", discriminator_path=ge2e_ckpt)
    _resumes(main, cfg_dir, ["--use_clf", "--clf_featurization", featurization])
    cfg = load_config_dir(cfg_dir)
    trainer = build_experiment(cfg, use_clf=True, device="cpu")
    saved = torch.load(ge2e_ckpt, weights_only=True)["embedder_net"]
    assert trainer.discriminator.hidden == 256  # the checkpoint's width, not model.yaml's
    for k, v in trainer.discriminator.state_dict().items():
        assert torch.equal(v, saved[k]), k
    payload = torch.load(CheckpointManager(cfg.train.path.ckpt_path).path(4), weights_only=True)
    assert "discriminator" not in payload  # the frozen discriminator is not trained state


def test_train_ganlike_cli_resumes(corpus):
    """`cli.train_ganlike` with a random discriminator (no discriminator_path,
    model.yaml's hidden 32, seeded from seed + 1): save, resume, and the
    reference's {"model", "discriminator", "optimizer"} layout."""
    from masg_tpu_torch.cli.train_ganlike import main
    from masg_tpu_torch.core.checkpoint import CheckpointManager
    from masg_tpu_torch.core.config import load_config_dir

    cfg_dir = _config(corpus, "ganlike")
    state = _resumes(main, cfg_dir)
    assert isinstance(state.model, GANLike) and state.model.discriminator.hidden == 32
    cfg = load_config_dir(cfg_dir)
    payload = torch.load(CheckpointManager(cfg.train.path.ckpt_path).path(4), weights_only=True)
    assert {"model", "discriminator", "optimizer"} <= set(payload)
    assert set(payload["discriminator"]) == set(state.model.discriminator.state_dict())
    n_fs2 = len(payload["model"]) - sum(1 for k in payload["model"]
                                        if k.endswith(("running_mean", "running_var",
                                                       "num_batches_tracked", "_bins",
                                                       "position_enc")))
    assert len(payload["optimizer"]["state"]) == n_fs2 + len(payload["discriminator"])
    # the FastSpeech2 half is what inference loads
    from masg_tpu_torch.infer.synthesis import load_model

    load_model(cfg, checkpoint=CheckpointManager(cfg.train.path.ckpt_path).path(4),
               device="cpu")


def test_missing_discriminator_path_is_an_error(corpus):
    from masg_tpu_torch.cli.train import main
    from masg_tpu_torch.cli.train_ganlike import main as ganlike_main

    cfg_dir = _config(corpus, "missing", discriminator_path="/nonexistent/ge2e.pth")
    with pytest.raises(FileNotFoundError, match="discriminator_path does not exist"):
        main(["-c", cfg_dir, "--device", "cpu", "--use_clf", "--max_steps", "1"])
    with pytest.raises(FileNotFoundError, match="discriminator_path does not exist"):
        ganlike_main(["-c", cfg_dir, "--device", "cpu", "--max_steps", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ganlike_main(["-c", _config(corpus, "card"), "--max_steps", "1"])
