"""The port's feature extraction and mel dumping against masg_tpu's:
`mel_spectrogram_and_energy`, the native F0 extension (bit for bit, and
against the numpy DIO at masg_tpu's own bar), `make_synthetic_corpus`, the
`Preprocessor` end to end through `cli.preprocess --device cpu` on one raw
corpus, and `cli.dump_mels --device cpu` on a checkpoint holding masg_tpu's
weights against masg_tpu's eval forward."""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.audio import f0 as jf0
from masg_tpu.audio.f0_native import dio_native as jax_dio_native
from masg_tpu.audio.f0_native import dio_stonemask_native as jax_dio_stonemask_native
from masg_tpu.audio.stft import mel_spectrogram_and_energy as jax_mel_and_energy
from masg_tpu.data.synthetic import make_synthetic_corpus as jax_make_synthetic_corpus
from masg_tpu.preprocessor.preprocessor import Preprocessor as JaxPreprocessor
from masg_tpu_torch.audio.f0 import extract_f0
from masg_tpu_torch.audio.f0_native import dio_native, dio_stonemask_native
from masg_tpu_torch.audio.stft import mel_spectrogram_and_energy
from masg_tpu_torch.data.synthetic import make_synthetic_corpus, write_config_dir
from test_f0 import FRAME_PERIOD, SR, synth_tone
import torch_port_support  # noqa: F401  (the port tests' thread count)


def _peak_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


def test_mel_spectrogram_and_energy_matches_masg_tpu():
    """Log-mel and energy of clipped audio (samples beyond ±1 included) at
    two lengths, within 1e-5 of the peak; the frame count 1 + T // hop."""
    rng = np.random.default_rng(0)
    for n in (5000, 22050):
        audio = (0.4 * rng.normal(size=n)).astype(np.float32)
        audio[10] = 1.7
        want_mel, want_e = jax_mel_and_energy(jnp.asarray(audio))
        got_mel, got_e = mel_spectrogram_and_energy(torch.from_numpy(audio))
        assert got_mel.shape == want_mel.shape == (80, 1 + n // 256)
        errs = (_peak_err(got_mel, want_mel), _peak_err(got_e, want_e))
        print(f"[parity] mel_spectrogram_and_energy T={n}: mel {errs[0]:.3g}, energy "
              f"{errs[1]:.3g} of the peak")
        assert max(errs) <= 1e-5


def test_native_f0_matches_masg_tpu_and_numpy():
    """The port's build of the copied f0.cpp gives masg_tpu's native results
    bit for bit (DIO alone and with StoneMask, a tone, noise, silence); and
    it holds masg_tpu's own native-vs-numpy bar (tests/test_f0_native.py:
    voiced decisions agree on > 97 % of frames, F0 within 5e-3 where both
    are voiced; StoneMask within 0.5 % of the true F0)."""
    rng = np.random.default_rng(1)
    signals = (synth_tone(220.0, noise=0.01), 0.1 * rng.normal(size=SR), np.zeros(4000))
    for x in signals:
        for got, want in ((dio_native(x, SR, FRAME_PERIOD), jax_dio_native(x, SR, FRAME_PERIOD)),
                          (dio_stonemask_native(x, SR, FRAME_PERIOD),
                           jax_dio_stonemask_native(x, SR, FRAME_PERIOD))):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    x = signals[0]
    ref, _ = jf0.dio(x, SR, FRAME_PERIOD)
    out = dio_native(x, SR, FRAME_PERIOD)
    assert len(out) == len(ref) and np.mean((out > 0) == (ref > 0)) > 0.97
    both = (out > 0) & (ref > 0)
    np.testing.assert_allclose(out[both], ref[both], rtol=5e-3)
    for f0_true in (132.5, 287.0):
        voiced = extract_f0(synth_tone(f0_true, noise=0.01, seed=3), SR, FRAME_PERIOD)
        voiced = voiced[voiced > 0]
        assert np.median(np.abs(voiced - f0_true)) / f0_true < 0.005


def _tree_files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_preprocess_cli_matches_masg_tpu(tmp_path):
    """`make_synthetic_corpus` (2 speakers x 4 utterances) writes masg_tpu's
    files byte for byte; `cli.preprocess --device cpu` on it against
    masg_tpu's `Preprocessor` on its own copy, `random` seeded alike: the same
    files and splits, identical duration and pitch arrays, the mel (linear,
    exp of the stored log-mel) and energy within 1e-5 of each file's peak,
    stats.json within 1e-5 relative. The stored log-mel is held at 1e-3 of
    its peak: at near-silent bins (log-mel ~ -11.4) an f32 STFT is 2e-4 of
    the peak off the f64 one, masg_tpu's XLA FFT as much as torch's."""
    from masg_tpu_torch.cli.preprocess import main as preprocess_main

    kw = dict(n_speakers=2, utts_per_speaker=4, seed=3)
    raw_j, pre_j, config_j = jax_make_synthetic_corpus(str(tmp_path / "jax"), **kw)
    raw_t, pre_t, _ = make_synthetic_corpus(str(tmp_path / "port"), **kw)
    assert _tree_files(raw_t) == _tree_files(raw_j)
    assert _tree_files(pre_t) == _tree_files(pre_j)

    random.seed(0)
    JaxPreprocessor(config_j).build_from_path()
    cfg_dir = write_config_dir(str(tmp_path / "cfg"), pre_t, str(tmp_path / "out"),
                               raw_path=raw_t)
    if not torch.cuda.is_available():  # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            preprocess_main(["--config", cfg_dir])
    random.seed(0)
    preprocess_main(["--config", cfg_dir, "--device", "cpu"])

    for split in ("train.txt", "val.txt", "test.txt"):
        with open(os.path.join(pre_t, split)) as a, open(os.path.join(pre_j, split)) as b:
            assert a.read() == b.read(), split
    errs = {"mel": 0.0, "log-mel": 0.0, "energy": 0.0}
    for kind in ("duration", "pitch", "mel", "energy"):
        names = sorted(os.listdir(os.path.join(pre_t, kind)))
        assert names == sorted(os.listdir(os.path.join(pre_j, kind))) and len(names) == 8
        for n in names:
            got = np.load(os.path.join(pre_t, kind, n))
            want = np.load(os.path.join(pre_j, kind, n))
            assert got.shape == want.shape and got.dtype == want.dtype, (kind, n)
            if kind in ("duration", "pitch"):
                assert np.array_equal(got, want), (kind, n)
            elif kind == "mel":
                errs["mel"] = max(errs["mel"], _peak_err(np.exp(got), np.exp(want)))
                errs["log-mel"] = max(errs["log-mel"], _peak_err(got, want))
            else:
                errs[kind] = max(errs[kind], _peak_err(got, want))
    with open(os.path.join(pre_t, "stats.json")) as a, open(os.path.join(pre_j, "stats.json")) as b:
        got, want = json.load(a), json.load(b)
    stat_err = max(abs(g - w) / max(abs(w), 1e-30)
                   for k in ("pitch", "energy") for g, w in zip(got[k], want[k]))
    print(f"[parity] cli.preprocess vs masg_tpu: mel {errs['mel']:.3g} (log-mel "
          f"{errs['log-mel']:.3g}), energy {errs['energy']:.3g} of the peak; stats.json "
          f"{stat_err:.3g} relative")
    assert errs["mel"] <= 1e-5 and errs["energy"] <= 1e-5 and stat_err <= 1e-5
    assert errs["log-mel"] <= 1e-3
    assert got["pitch"] == want["pitch"]


def test_dump_mels_cli_matches_masg_tpu_forward(tmp_path):
    """`cli.dump_mels --device cpu` on a port checkpoint holding masg_tpu's
    FastSpeech2 weights (a tiny width, a random preprocessed corpus): the
    same `{speaker}-mel-{id}.npy` names masg_tpu's dump would write, each
    postnet mel trimmed at its mel_len and within 2e-4 of masg_tpu's
    `train.step._forward(train=False)` (what its dump_mels jits) on the
    same batch."""
    from masg_tpu.core.config import load_config_dir as jax_load_config_dir
    from masg_tpu.models import FastSpeech2 as JaxFastSpeech2
    from masg_tpu.train.step import _forward as jax_forward
    from masg_tpu_torch.cli.dump_mels import main as dump_main
    from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax
    from masg_tpu_torch.core.config import load_config_dir
    from masg_tpu_torch.data.dataset import Dataset
    from masg_tpu_torch.data.synthetic import write_preprocessed_corpus
    from masg_tpu_torch.train.loop import build_corpus_dict, build_experiment

    tiny = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                            "decoder_hidden": 64, "conv_filter_size": 128},
            "variance_predictor": {"filter_size": 64}}
    pre = write_preprocessed_corpus(str(tmp_path / "pre"), n_utts=10, n_val=3, phones=(5, 12),
                                    frames_per_phone=(1, 4))
    cfg_dir = write_config_dir(str(tmp_path / "cfg"), pre, str(tmp_path / "out"), model=tiny,
                               optimizer={"batch_size": 4})
    cfg = load_config_dir(cfg_dir)
    ds = Dataset("train.txt", build_corpus_dict(cfg, "SYNTH"), batch_size=4, text_bucket=16,
                 mel_bucket=64)
    order = np.argsort([-len(t.split()) for t in ds.text])
    data = [ds[int(j)] for j in order[:4]]  # the first batch dump_mels forms
    batch = {k: v for k, v in ds.reprocess(data, range(4)).items()
             if k not in ("ids", "raw_texts")}

    jcfg = jax_load_config_dir(cfg_dir)
    model = JaxFastSpeech2.from_config(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda key: model.init(
        key, jb["speakers"], jb["texts"], jb["src_lens"], jb["mels"].shape[1],
        mel_lens=jb["mel_lens"], p_targets=jb["pitches"], e_targets=jb["energies"],
        d_targets=jb["durations"], accents=jb["accents"], speaker_meta=jb["speaker_meta"]))
    variables = jax.device_get(init(jax.random.PRNGKey(0)))
    params, bstats = variables["params"], variables["batch_stats"]
    out, _ = jax.jit(lambda b: jax_forward(model, params, bstats, b, rng=None, train=False))(jb)
    want_mel, want_len = np.asarray(out.postnet_mel), np.asarray(out.mel_len)

    trainer = build_experiment(cfg, device="cpu")
    trainer.state.fs2.load_state_dict(fs2_state_dict_from_jax(params, bstats, cfg), strict=True)
    trainer.ckpt.save(1, trainer.state)
    out_dir = str(tmp_path / "mels")
    n = dump_main(["-c", cfg_dir, "--restore_step", "1", "--out", out_dir, "--device", "cpu",
                   "--split", "train.txt", "val.txt"])
    names = sorted(os.listdir(out_dir))
    assert n == 13 and names == sorted(f"{s}-mel-{b}.npy" for s, b in zip(ds.speaker, ds.basename))
    err = 0.0
    for j, d in enumerate(data):
        got = np.load(os.path.join(out_dir, f"{d['speaker_name']}-mel-{d['id']}.npy"))
        assert got.shape == (int(want_len[j]), 80) == d["mel"].shape
        err = max(err, float(np.abs(got - want_mel[j, : int(want_len[j])]).max()))
    print(f"[parity] cli.dump_mels vs masg_tpu's eval forward: max err {err:.3g}")
    assert err <= 2e-4
