"""The port's trainer entry points on the CPU: its Dataset / GroupedLoader
copies against masg_tpu's, `cli.train --device cpu` with save, deterministic
resume (dropout on) and `cli.evaluate`, checkpoint rotation, and the
variants: `--use_clf`, ganlike and JDIT build."""

import json
import os

import numpy as np
import pytest
import torch

from masg_tpu.data.dataset import Dataset as JaxDataset
from masg_tpu.data.loader import GroupedLoader as JaxGroupedLoader
from masg_tpu_torch.cli.evaluate import main as evaluate_main
from masg_tpu_torch.cli.train import main as train_main
from masg_tpu_torch.core.checkpoint import CheckpointManager
from masg_tpu_torch.core.config import load_config_dir
from masg_tpu_torch.data.dataset import Dataset
from masg_tpu_torch.data.loader import GroupedLoader
from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus
from masg_tpu_torch.train.loop import build_corpus_dict
import torch_port_support  # noqa: F401  (the port tests' thread count)

TINY = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                        "decoder_hidden": 64, "conv_filter_size": 128},
        "variance_predictor": {"filter_size": 64}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 utterances over 4 speakers, batch 4: three batches an epoch."""
    root = tmp_path_factory.mktemp("corpus")
    pre = write_preprocessed_corpus(str(root / "pre"), n_utts=12, n_speakers=4, n_val=4,
                                    phones=(5, 12), frames_per_phone=(1, 4))
    return root, pre


def _config(corpus, name, grad_acc_step=1, **step):
    root, pre = corpus
    return write_config_dir(str(root / name / "cfg"), pre, str(root / name / "out"),
                            model=TINY, optimizer={"batch_size": 4, "warm_up_step": 10,
                                                   "grad_acc_step": grad_acc_step},
                            step=step)


def _total_losses(cfg_dir):
    """(step, total loss) in logging order, from the train logger's JSONL."""
    cfg = load_config_dir(cfg_dir)
    path = os.path.join(cfg.train.path.log_path, "train", "scalars.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == "Loss/total_loss"]


def test_dataset_and_loader_copies_match_masg_tpu(corpus):
    cfg = load_config_dir(_config(corpus, "data"))
    corpus_dict = build_corpus_dict(cfg, "SYNTH")
    kw = dict(batch_size=4, sort=True, drop_last=True, text_bucket=16, mel_bucket=64)
    ours = GroupedLoader(Dataset("train.txt", corpus_dict, **kw), batch_size=4,
                         group_size=2, seed=3)
    theirs = JaxGroupedLoader(JaxDataset("train.txt", corpus_dict, **kw), batch_size=4,
                              group_size=2, seed=3)
    assert ours.batches_per_epoch == theirs.batches_per_epoch
    n = 0
    for _ in range(2):
        for ga, gb in zip(ours, theirs, strict=True):
            for a, b in zip(ga, gb, strict=True):
                assert a.keys() == b.keys()
                for k in a:
                    if isinstance(a[k], np.ndarray):
                        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
                    else:
                        assert a[k] == b[k], k
                n += 1
    assert n == 2 * ours.batches_per_epoch


@pytest.mark.parametrize("grad_acc_step, restore, total", [(1, 2, 4), (2, 3, 5)])
def test_train_cli_saves_and_resumes_to_the_same_losses(corpus, grad_acc_step, restore,
                                                        total):
    """`total` steps with dropout on, then a run restored at `restore` (which
    skips batches of its epoch; with grad_acc_step = 2, mid-accumulation)
    repeats the later steps' losses bit for bit."""
    cfg_dir = _config(corpus, f"resume{grad_acc_step}", grad_acc_step=grad_acc_step,
                      save_step=restore if grad_acc_step > 1 else 2, val_step=4)
    state = train_main(["-c", cfg_dir, "--device", "cpu", "--max_steps", str(total)])
    assert state.step == total and state.scheduler.last_epoch == total // grad_acc_step
    cfg = load_config_dir(cfg_dir)
    assert restore in CheckpointManager(cfg.train.path.ckpt_path).all_steps()
    first = dict(_total_losses(cfg_dir))
    assert sorted(first) == list(range(1, total + 1))

    resumed = train_main(["-c", cfg_dir, "--device", "cpu", "--restore_step", str(restore),
                          "--max_steps", str(total - restore)])
    second = _total_losses(cfg_dir)[total:]
    assert [s for s, _ in second] == list(range(restore + 1, total + 1))
    assert [v for _, v in second] == [first[s] for s, _ in second]
    assert resumed.step == total

    # the resumed losses matched with dropout on
    assert any(isinstance(x, torch.nn.Dropout) and x.p > 0 for x in resumed.model.modules())

    means = evaluate_main(["-c", cfg_dir, "--device", "cpu", "--restore_step", str(restore)])
    assert len(means) == 6 and all(np.isfinite(means))

    # the checkpoint holds reference-format weights that synthesis loads
    from masg_tpu_torch.infer.synthesis import load_model

    load_model(cfg, checkpoint=os.path.join(cfg.train.path.ckpt_path, f"{restore}.pth.tar"),
               device="cpu")


def test_checkpoint_keep_last_rotates(corpus):
    cfg_dir = _config(corpus, "rotate", save_step=1, keep_last=2)
    train_main(["-c", cfg_dir, "--device", "cpu", "--max_steps", "4", "--no-use_flash"])
    cfg = load_config_dir(cfg_dir)
    mgr = CheckpointManager(cfg.train.path.ckpt_path)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    with pytest.raises(FileNotFoundError, match="no checkpoint for step 1"):
        mgr.restore_model_only(1, None)

    # --checkpoint: another run's weights (its latest step), not its optimizer
    from masg_tpu_torch.train.loop import build_experiment

    warm = build_experiment(load_config_dir(_config(corpus, "warm")),
                            checkpoint=cfg.train.path.ckpt_path, device="cpu")
    saved = torch.load(mgr.path(4), weights_only=True)["model"]
    for name, value in warm.model.state_dict().items():
        assert torch.equal(value, saved[name]), name
    assert warm.state.step == 0 and not warm.state.optimizer.state


def test_unported_variants_raise(corpus):
    """`--use_clf` and ganlike (queue 1 item 8) and JDIT (item 11) are ported
    and build; JDIT with each of them and with `--param_storage bf16` builds
    as masg_tpu's does."""
    cfg_dir = _config(corpus, "unported")
    from masg_tpu_torch.models.ganlike import GANLike
    from masg_tpu_torch.train.loop import build_experiment

    cfg = load_config_dir(cfg_dir)
    clf = build_experiment(cfg, use_clf=True, device="cpu")
    assert clf.discriminator is not None and clf.state.model is clf.model
    assert all(not p.requires_grad for p in clf.discriminator.parameters())
    gan = build_experiment(cfg, ganlike=True, device="cpu")
    assert isinstance(gan.state.model, GANLike) and gan.state.fs2 is gan.model
    assert gan.state.discriminator is gan.state.model.discriminator
    # the clip covers the FastSpeech2 half only (masg_tpu's clip_subtree="model")
    assert gan.state.clip_mask() == [n.startswith("model.") for n, p in
                                     gan.state.model.named_parameters() if p.requires_grad]
    cfg.model.jdit.use_jdit = True
    for kw in ({}, {"use_clf": True}, {"ganlike": True}, {"param_storage": "bf16"}):
        trainer = build_experiment(cfg, device="cpu", **kw)
        assert trainer.model.jdit is not None, kw
        teacher = [p for n, p in trainer.state.model.named_parameters() if ".jdit." in f".{n}"]
        assert teacher and all(p.requires_grad for p in teacher), kw


def test_train_cli_defaults_to_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["-c", _config(corpus, "card"), "--max_steps", "1"])


def test_sigterm_saves_and_returns(corpus):
    """SIGTERM during a step: the loop finishes it, saves at that step and
    returns; the previous handler is back afterwards."""
    import signal

    from masg_tpu_torch.train.loop import build_experiment

    cfg = load_config_dir(_config(corpus, "sigterm", save_step=1000))
    trainer = build_experiment(cfg, device="cpu")
    inner = trainer.train_step_fn

    def step_then_signal(state, *args):
        out = inner(state, *args)
        if out[0].step == 2:
            signal.raise_signal(signal.SIGTERM)
        return out

    trainer.train_step_fn = step_then_signal
    before = signal.getsignal(signal.SIGTERM)
    state = trainer.fit(max_steps=10, verbose=False)
    assert state.step == 2 and trainer.ckpt.all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is before
