"""`-r/--restore_step` of the port's inference entry points on the CPU: after
two steps of `cli.train`, `cli.synthesize -r 2` gives the same mel and wav as
`cli.synthesize --checkpoint <ckpt_path>/2.pth.tar`, and `cli.speaker_gen -r 2`
the same embedding, as masg_tpu's CLIs restore the model from the
experiment's own checkpoint directory."""

import glob
import math
import os

import numpy as np
import pytest
import torch

from masg_tpu_torch.audio.wavio import read_wav
from masg_tpu_torch.cli.speaker_gen import main as speaker_gen_main
from masg_tpu_torch.cli.synthesize import main as synthesize_main
from masg_tpu_torch.cli.train import main as train_main
from masg_tpu_torch.compat.from_jax import with_duration_bias
from masg_tpu_torch.core.config import load_config_dir
from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus
from masg_tpu_torch.infer.synthesis import load_model

torch.set_num_threads(2)

TINY = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                        "decoder_hidden": 64, "conv_filter_size": 128},
        "variance_predictor": {"filter_size": 64}}
PHONES = "{k o N n i ch i w a}"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two CPU steps of cli.train, warm-started from weights whose duration
    bias (ln 5) gives nonzero mel lengths, saving at step 2."""
    root = tmp_path_factory.mktemp("restore")
    pre = write_preprocessed_corpus(str(root / "pre"), n_utts=12, n_speakers=4, n_val=4,
                                    phones=(5, 12), frames_per_phone=(1, 4))
    cfg_dir = write_config_dir(str(root / "cfg"), pre, str(root / "out"), model=TINY,
                               optimizer={"batch_size": 4, "warm_up_step": 10},
                               step={"save_step": 2})
    cfg = load_config_dir(cfg_dir)
    warm = root / "warm"  # another run's checkpoint directory, as cli.train takes it
    warm.mkdir()
    sd = with_duration_bias(load_model(cfg, device="cpu").state_dict(), math.log(5.0))
    torch.save({"model": sd}, warm / "1.pth.tar")
    train_main(["-c", cfg_dir, "--device", "cpu", "--max_steps", "2", "--checkpoint",
                str(warm)])
    ckpt = os.path.join(cfg.train.path.ckpt_path, "2.pth.tar")
    assert os.path.exists(ckpt)
    return root, cfg_dir, cfg, ckpt


def _synthesize(cfg_dir, out, *weights):
    synthesize_main(["-c", cfg_dir, *weights, "--device", "cpu", "--phones", PHONES,
                     "--max_frames", "64", "--result_path", str(out)])
    (wav,) = glob.glob(str(out / "*.wav"))
    return read_wav(wav)


def test_synthesize_restore_step_equals_checkpoint_file(trained, capsys):
    root, cfg_dir, cfg, ckpt = trained
    by_step = load_model(cfg, device="cpu", restore_step=2)
    by_file = load_model(cfg, ckpt, device="cpu")
    saved = torch.load(ckpt, weights_only=True)["model"]
    for name, value in by_step.state_dict().items():
        assert torch.equal(value, by_file.state_dict()[name]) and torch.equal(value, saved[name])

    # the mel of the one-utterance path, as `cli.synthesize` builds its batch
    from masg_tpu_torch.cli.synthesize import single_utterance_batch
    from masg_tpu_torch.infer.synthesis import synthesize_batch
    from masg_tpu_torch.text import phone_string_to_sequence

    batch = single_utterance_batch(phone_string_to_sequence(PHONES), None)
    batch.update(speakers=np.zeros(1, np.int32),
                 speaker_meta=np.zeros((1, cfg.preprocess.speaker_generation.one_hot_dim),
                                       np.float32))
    mels = [synthesize_batch(m, batch, max_mel_len=64) for m in (by_step, by_file)]
    assert int(mels[0].mel_len[0]) > 0
    assert torch.equal(mels[0].postnet_mel, mels[1].postnet_mel)

    wav_a, sr_a = _synthesize(cfg_dir, root / "by_step", "-r", "2")
    assert "RANDOM" not in capsys.readouterr().out
    wav_b, sr_b = _synthesize(cfg_dir, root / "by_file", "--checkpoint", ckpt)
    assert sr_a == sr_b and wav_a.size > 0
    assert np.array_equal(wav_a, wav_b)

    with pytest.raises(ValueError, match="not both"):
        load_model(cfg, ckpt, device="cpu", restore_step=2)
    with pytest.raises(FileNotFoundError, match="no checkpoint for step 3"):
        load_model(cfg, device="cpu", restore_step=3)


def test_random_weights_warn_as_masg_tpu(trained, capsys):
    root, cfg_dir, _, _ = trained
    synthesize_main(["-c", cfg_dir, "--device", "cpu", "--phones", PHONES, "--no_vocoder",
                     "--max_frames", "64", "--result_path", str(root / "random")])
    assert "WARNING: --restore_step 0 synthesizes with RANDOM weights" in capsys.readouterr().out


def test_speaker_gen_restore_step_equals_checkpoint_file(trained, capsys):
    root, cfg_dir, _, ckpt = trained
    outs = []
    for name, weights in (("step", ["-r", "2"]), ("file", ["--checkpoint", ckpt])):
        out = str(root / f"spk_{name}.npy")
        speaker_gen_main(["-c", cfg_dir, *weights, "--device", "cpu", "-o", out])
        outs.append(np.load(out))
    assert "RANDOM" not in capsys.readouterr().out
    assert outs[0].shape == outs[1].shape and np.array_equal(outs[0], outs[1])
