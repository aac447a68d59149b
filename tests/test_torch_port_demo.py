"""The demos' port (masg_tpu_torch.demo) on the CPU: `make_config_dir` and
`build_synthetic_experiment_dir` against masg_tpu's, and every stage of the
full-pipeline demo end to end at tiny budgets (2 steps of each FastSpeech2
trainer, 2 GE2E epochs of one batch, one vocoder step of a tiny vocoder) on
the corpus the parity test builds, with `mid_attribute` after it.

The learning gates need the real budgets and run on the card (`chip_smoke.py`
`[demo]`); here every artifact and evidence value must exist and be finite,
and the adversarial branch must be live: one `--use_clf` step at lambda 1000
moves the parameters by more than 1e-6 from the same step at lambda 0."""

import functools
import json
import math
import os
import random
import shutil

import numpy as np
import pytest

from masg_tpu.data.synthetic import build_synthetic_experiment_dir as jax_build_experiment_dir
from masg_tpu.data.synthetic import make_config_dir as jax_make_config_dir
from masg_tpu_torch.data.synthetic import build_synthetic_experiment_dir, make_config_dir
from masg_tpu_torch.demo import full_pipeline, mid_attribute, stages
import torch_port_support  # noqa: F401  (the port tests' thread count)

# a tiny HiFi-GAN (stages of C = 16, 8, 4, 2) and discriminators
TINY_HIFIGAN = {
    **stages.DEMO_HIFIGAN, "segment_size": 512, "batch_size": 2,
    "upsample_initial_channel": 32, "mpd_periods": [2, 3], "mpd_channels": [4, 8, 16, 16],
    "msd_layers": [[8, 15, 1, 1], [16, 41, 4, 4], [16, 5, 1, 1]]}


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("kw", [{}, dict(batch_size=8, group_size=1, total_step=800,
                                         log_step=100, val_step=10**9, synth_step=10**9,
                                         save_step=800, warm_up_step=100),
                                dict(use_jdit=True, discriminator_path="/x/final_epoch_40.pth",
                                     lambd=10.0, out_subdir="out_clf", dataset="JSUT")])
def test_make_config_dir_writes_masg_tpus_yaml(tmp_path, kw):
    """The same arguments give byte-identical YAML files (written in turn into
    one directory: the files name it)."""
    root, pre, tmp = str(tmp_path / "root"), str(tmp_path / "pre"), str(tmp_path / "cfg")
    want = _files(jax_make_config_dir(root, pre, tmp, **kw))
    shutil.rmtree(tmp)
    got = _files(make_config_dir(root, pre, tmp, **kw))
    assert len(want) == 4 and got == want


# masg_tpu's demo corpus (scripts/demo_full_pipeline.py:105-112: 8 phones an
# utterance) at 4 utterances a speaker, its config at 2 FastSpeech2 steps:
# `stages.build_corpus(fs2_steps=2)` reuses it
DEMO_CORPUS = dict(n_speakers=4, utts_per_speaker=4, style="vocal",
                   languages=("ja", "ja", "en", "en"), voice_variation=True, batch_size=8,
                   group_size=1, total_step=2, log_step=100, val_step=10**9,
                   synth_step=10**9, save_step=2, warm_up_step=100)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The demo corpus through both packages' `build_synthetic_experiment_dir`
    (the port's `cli.preprocess --device cpu`), `random` seeded alike, with
    each config dir's files as built (the demo adds to the port's)."""
    root = tmp_path_factory.mktemp("corpora")
    random.seed(0)
    cfg_j = jax_build_experiment_dir(str(root / "jax"), **DEMO_CORPUS)
    random.seed(0)
    cfg_t = build_synthetic_experiment_dir(str(root / "port"), device="cpu", **DEMO_CORPUS)
    return root, _files(cfg_j), _files(cfg_t)


def test_build_synthetic_experiment_dir_matches_masg_tpu(corpora):
    """The same config files, speakers.json, splits and durations and pitch,
    the mel (linear) and energy within 1e-5 of each file's peak (log-mel
    1e-3), stats.json within 1e-5 relative
    (tests/test_torch_port_preprocess.py's bars)."""
    root, files_j, files_t = corpora
    assert sorted(files_j) == sorted(files_t)
    for name in files_j:
        if name != "stats.json":  # YAML paths name each package's directory
            assert files_t[name] == files_j[name].replace(b"/jax/", b"/port/"), name
    pre_j = str(root / "jax" / "preprocessed_data" / "SYNTH")
    pre_t = str(root / "port" / "preprocessed_data" / "SYNTH")
    for split in ("speakers.json", "train.txt", "val.txt", "test.txt"):
        with open(os.path.join(pre_t, split)) as a, open(os.path.join(pre_j, split)) as b:
            assert a.read() == b.read(), split
    errs = {"mel": 0.0, "log-mel": 0.0, "energy": 0.0}
    for kind in ("duration", "pitch", "mel", "energy"):
        names = sorted(os.listdir(os.path.join(pre_j, kind)))
        assert names == sorted(os.listdir(os.path.join(pre_t, kind))) and len(names) == 16
        for n in names:
            got, want = (np.load(os.path.join(p, kind, n)) for p in (pre_t, pre_j))
            assert got.shape == want.shape and got.dtype == want.dtype, (kind, n)
            if kind in ("duration", "pitch"):
                assert np.array_equal(got, want), (kind, n)
                continue
            pairs = ((np.exp(got), np.exp(want), "mel"), (got, want, "log-mel")) \
                if kind == "mel" else ((got, want, kind),)
            for g, w, key in pairs:
                errs[key] = max(errs[key], float(np.abs(g - w).max() / np.abs(w).max()))
    stats = [json.loads(files[n]) for files, n in ((files_t, "stats.json"),
                                                   (files_j, "stats.json"))]
    stat_err = max(abs(g - w) / max(abs(w), 1e-30) for k in ("pitch", "energy")
                   for g, w in zip(stats[0][k], stats[1][k]))
    print(f"[parity] build_synthetic_experiment_dir vs masg_tpu: mel {errs['mel']:.3g} (log-mel "
          f"{errs['log-mel']:.3g}), energy {errs['energy']:.3g} of the peak; stats.json "
          f"{stat_err:.3g} relative")
    assert errs["mel"] <= 1e-5 and errs["energy"] <= 1e-5 and stat_err <= 1e-5
    assert errs["log-mel"] <= 1e-3


@pytest.fixture(scope="module")
def demo(corpora):
    """`full_pipeline.run` in the port's corpus dir at tiny budgets; the GE2E
    batches per epoch and the EER rounds, fixed in masg_tpu's demo, are cut
    here by wrapping the stage functions."""
    out = str(corpora[0] / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stages, "train_ge2e", functools.partial(stages.train_ge2e,
                                                           batches_per_epoch=1))
        mp.setattr(stages, "ge2e_eer", functools.partial(stages.ge2e_eer, epochs=1))
        result = full_pipeline.run(out, utts_per_speaker=4, fs2_steps=2, clf_steps=2,
                                   ge2e_epochs=2, vocoder_steps=1, n_speakers_sampled=1,
                                   hifigan=TINY_HIFIGAN, device="cpu")
    return out, result


def _finite(value):
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(_finite(v) for v in value)
    return math.isfinite(float(value))


def test_full_pipeline_stages_run_end_to_end(demo):
    out, result = demo
    for path in ("config/stats.json", "config/hifigan_config.json", "config_langemb/train.yaml",
                 "spk_enc/final_epoch_2.pth", "out/ckpt/2.pth.tar", "out_clf/ckpt/2.pth.tar",
                 "vocoder/generator_1.pth.tar", "interp_M_F_ja.npz", "barycenter_all.npz",
                 "wavs_interp/gen001_ja.wav", "wavs_barycenter/gen001_ja.wav",
                 "evidence.json"):
        assert os.path.exists(os.path.join(out, path)), path
    assert len(os.listdir(os.path.join(out, "ge2e_chunks"))) == 4
    ev = result["evidence"]
    for key in ("ge2e_first_epoch_loss", "ge2e_last_epoch_loss", "ge2e_eer", "ge2e_eer_threshold",
                "clf_dloss", "clf_liveness_max_param_delta",
                "vocoder_copy_synthesis_peak_median", "vocoder_copy_synthesis_mcd_db",
                "demo_wav_peak_median", "demo_wav_peak_min", "mid_attribute_f0",
                "mid_attribute_f0_score_median"):
        assert key in ev and _finite(ev[key]), (key, ev.get(key))
    assert ev["clf_dloss"] and all(v > 0 for _, v in ev["clf_dloss"])
    assert len(result["checks"]) == 7 and len(result["stages"]) == 11
    with open(os.path.join(out, "evidence.json")) as f:
        assert json.load(f)["checks"] == result["checks"]
    # no kernel launches on the CPU
    assert all(n == 0 for _, _, launches in result["stages"] for n in launches.values())


def test_adversarial_branch_is_live(demo):
    """One lambda-1000 `--use_clf` step from the pretrain moves the
    parameters away from the lambda-0 step by more than 1e-6."""
    _, result = demo
    delta = result["evidence"]["clf_liveness_max_param_delta"]
    print(f"[demo] lambda 0 vs 1000 parameter delta {delta:.3g} (gate > 1e-6)")
    assert delta > 1e-6 and result["checks"]["clf_liveness_delta_above_1e-6"][0]


def test_mid_attribute_demo_runs_its_stages(demo, monkeypatch):
    """`mid_attribute.main` on the same corpus (its config dir is reused) with
    the tiny vocoder in place of DEMO_HIFIGAN: FastSpeech2, vocoder,
    distributions from its own model, and wavs from each."""
    out, _ = demo
    monkeypatch.setattr(stages, "DEMO_HIFIGAN", TINY_HIFIGAN)
    done = mid_attribute.main(["--out", out, "--fs2_steps", "2", "--vocoder_steps", "1",
                               "--n_speakers_sampled", "1", "--device", "cpu"])
    assert [s[0].split()[0] for s in done] == ["corpus", "FastSpeech2", "HiFi-GAN",
                                               "distributions", "interp:", "barycenter:"]
    for mode in ("interp", "barycenter"):
        assert os.path.exists(os.path.join(out, f"wavs_{mode}", "gen001_ja.wav"))


def test_probe_reports_copy_synthesis_of_a_generator(demo):
    """`demo.probe --generator` on the run's own vocoder: per speaker the
    output's peak, RMS, full-scale share and F0 beside the ground truth's."""
    from masg_tpu_torch.demo import probe

    out, _ = demo
    gen = os.path.join(out, "vocoder", "generator_1.pth.tar")
    result = probe.main(["--out", out, "--generator", gen, "--device", "cpu"])
    rows = result[gen]["copy_synthesis"]
    assert sorted(rows) == ["spk00", "spk01", "spk02", "spk03"]
    for row in rows.values():
        assert set(row) == {"peak", "rms", "gt_rms", "full_scale_share", "f0", "gt_f0"}
        assert _finite(row) and row["gt_rms"] > 0 and row["gt_f0"] > 0
    with open(os.path.join(out, "probe.json")) as f:
        assert json.load(f) == result
