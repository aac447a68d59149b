"""Synthetic corpora for smoke runs and tests, written with numpy.

- `write_preprocessed_corpus` / `write_config_dir`: a random PREPROCESSED
  corpus and a config dir for it, for the training path without audio or
  preprocessing: the files are laid out as the preprocessor writes them and
  `data.dataset.Dataset` reads them (`speakers.json`, `train.txt`/`val.txt`
  with `basename|speaker|{phones}|raw_text` lines, `mel|pitch|energy|
  duration/<speaker>-<kind>-<basename>.npy`, `stats.json`), with random
  features;
- `make_synthetic_corpus` and the synthesizers it calls are copied from
  masg_tpu/data/synthetic.py:39-260: a RAW corpus (`raw_data/<spk>/*.wav`
  and `.lab`, TextGrid alignments, accent files, `speakers.json`) for
  `cli.preprocess` and the vocoder CLIs;
- `make_config_dir` and `build_synthetic_experiment_dir`, copied from
  masg_tpu/data/synthetic.py:261-359: the config dir of masg_tpu's tests
  and demos (a 2 x 64-wide FastSpeech2) for such a corpus, and the corpus,
  `cli.preprocess` and that config dir in one call (the demos' first stage).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..audio.wavio import write_wav
from ..preprocessor.textgrid import Interval, TextGrid, Tier, write_textgrid

_PHONES = ("a", "i", "u", "e", "o", "k", "s", "t", "n", "m", "N", "ch", "w", "r", "g")
_METADATA = {"gender": {"M": 0, "F": 1}, "language": {"ja": 0, "en": 1}}


def write_preprocessed_corpus(pre_dir: str, n_utts: int = 32, n_speakers: int = 4,
                              n_val: int = 4, phones: Tuple[int, int] = (8, 40),
                              frames_per_phone: Tuple[int, int] = (1, 8),
                              n_mels: int = 80, seed: int = 0) -> str:
    """`n_utts` random utterances over `n_speakers` into `pre_dir`; all go to
    train.txt, the first `n_val` also to val.txt. Phone counts and frames per
    phone are drawn uniformly from the given inclusive ranges."""
    rng = np.random.default_rng(seed)
    speakers = {f"spk{i}": [i, "M" if i % 2 == 0 else "F", "ja" if i < n_speakers / 2 else "en"]
                for i in range(n_speakers)}
    for kind in ("mel", "pitch", "energy", "duration"):
        os.makedirs(os.path.join(pre_dir, kind), exist_ok=True)
    lines, pitch_all, energy_all = [], [], []
    for j in range(n_utts):
        spk, base = f"spk{j % n_speakers}", f"utt{j:04d}"
        n_ph = int(rng.integers(phones[0], phones[1] + 1))
        text = " ".join(rng.choice(_PHONES, n_ph))
        feats = {
            "duration": rng.integers(frames_per_phone[0], frames_per_phone[1] + 1,
                                     n_ph).astype(np.int64),
            "pitch": rng.normal(size=n_ph).astype(np.float32),
            "energy": rng.normal(size=n_ph).astype(np.float32),
        }
        feats["mel"] = rng.normal(size=(int(feats["duration"].sum()), n_mels)).astype(np.float32)
        for kind, arr in feats.items():
            np.save(os.path.join(pre_dir, kind, f"{spk}-{kind}-{base}.npy"), arr)
        pitch_all.append(feats["pitch"])
        energy_all.append(feats["energy"])
        lines.append(f"{base}|{spk}|{{{text}}}|{text}\n")
    with open(os.path.join(pre_dir, "train.txt"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(pre_dir, "val.txt"), "w") as f:
        f.writelines(lines[:n_val])
    with open(os.path.join(pre_dir, "speakers.json"), "w") as f:
        json.dump(speakers, f)
    stats = {}
    for name, vals in (("pitch", pitch_all), ("energy", energy_all)):
        v = np.concatenate(vals).astype(np.float64)
        stats[name] = [float(v.min()), float(v.max()), float(v.mean()), float(v.std())]
    with open(os.path.join(pre_dir, "stats.json"), "w") as f:
        json.dump(stats, f)
    return pre_dir


def write_config_dir(cfg_dir: str, pre_dir: str, out_dir: str,
                     model: Optional[Dict[str, Any]] = None,
                     optimizer: Optional[Dict[str, Any]] = None,
                     step: Optional[Dict[str, Any]] = None, group_size: int = 1,
                     dataset: str = "SYNTH", train: Optional[Dict[str, Any]] = None,
                     raw_path: str = "") -> str:
    """A reference-style config dir for the corpus in `pre_dir`, writing
    checkpoints and logs under `out_dir`. `model` is model.yaml (empty: the
    flagship `ModelConfig()` defaults); `optimizer` and `step` update
    train.yaml's sections, `train` its top level (e.g. `discriminator_path`,
    `lambda`). `raw_path` names a raw corpus (`make_synthetic_corpus`) for
    `cli.preprocess`; `pre_dir`'s stats.json and speakers.json are copied
    where they exist (stats.json only after preprocessing)."""
    import yaml

    os.makedirs(cfg_dir, exist_ok=True)
    preprocess = {
        "val_size": 0.2, "test_size": 0.2,
        "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
        "stft": {"filter_length": 1024, "hop_length": 256, "win_length": 1024},
        "mel": {"n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": 8000},
        "pitch": {"feature": "phoneme_level", "normalization": True},
        "energy": {"feature": "phoneme_level", "normalization": True},
        "speaker_generation": {"metadata": _METADATA},
    }
    train = {
        "path": {"ckpt_path": os.path.join(out_dir, "ckpt"),
                 "log_path": os.path.join(out_dir, "log"),
                 "result_path": os.path.join(out_dir, "result")},
        "optimizer": {"batch_size": 16, "betas": [0.9, 0.98], "eps": 1e-9,
                      "weight_decay": 0.0, "grad_clip_thresh": 1.0, "grad_acc_step": 1,
                      "warm_up_step": 4000, "anneal_steps": [300000, 400000, 500000],
                      "anneal_rate": 0.3, **(optimizer or {})},
        "step": {"total_step": 30000, "log_step": 1, "synth_step": 100000,
                 "val_step": 1000, "save_step": 1000, **(step or {})},
        "dataparallel": False,
        "group_size": group_size,
        **(train or {}),
    }
    corpus = {"dataset": dataset, "path": {"raw_path": raw_path, "preprocessed_path": pre_dir},
              "text": {"text_cleaners": [], "language": "ja"}, "accent": {"use_accent": False}}
    for name, doc in (("preprocess.yaml", preprocess), ("model.yaml", model or {}),
                      ("train.yaml", train), (f"preprocess_{dataset}.yaml", corpus)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.safe_dump(doc, f)
    for name in ("stats.json", "speakers.json"):
        if os.path.exists(os.path.join(pre_dir, name)):
            shutil.copy(os.path.join(pre_dir, name), os.path.join(cfg_dir, name))
    return cfg_dir


# ---------------------------------------------------------------------------
# copied from masg_tpu/data/synthetic.py:20-260 (numpy only)
# ---------------------------------------------------------------------------

SR = 22050

# tiny phone inventory drawn from the real symbol table
PHONES = ["a", "i", "u", "e", "o", "k", "s", "t", "n", "m"]

# vocal-style phone spectra: vowel/nasal formants (center Hz, relative gain)
# for the glottal-pulse source model (same machinery as the F0 fixture,
# scripts/make_vocal_fixture.py)
_FORMANTS = {
    "a": [(800, 1.0), (1200, 0.5), (2500, 0.25)],
    "i": [(300, 1.0), (2300, 0.5), (3000, 0.3)],
    "u": [(350, 1.0), (800, 0.6), (2250, 0.25)],
    "e": [(500, 1.0), (1800, 0.5), (2500, 0.3)],
    "o": [(450, 1.0), (900, 0.6), (2400, 0.25)],
    "n": [(250, 1.0), (1000, 0.35), (2200, 0.2)],
    "m": [(250, 1.0), (900, 0.3), (2100, 0.2)],
}


def _formant_gain(freq_hz, formants):
    """Sum of Gaussian resonance bumps + spectral tilt."""
    g = 0.05
    for fc, amp in formants:
        g = g + amp * np.exp(-0.5 * ((freq_hz - fc) / (0.12 * fc + 60.0)) ** 2)
    return g * (1.0 / (1.0 + freq_hz / 3000.0))


def _vocal_phone(rng, phone, n, f0, formant_scale=1.0):
    """One phone of speech-like audio: glottal harmonic source shaped by
    formant envelopes (+ aspiration) for vowels/nasals, shaped noise for
    fricatives, closure+burst for stops. f0: per-sample contour (len n).
    formant_scale: per-speaker vocal-tract-length proxy multiplying every
    formant center frequency."""
    tt = np.arange(n) / SR
    if phone == "s":
        noise = rng.normal(size=n)
        return 0.10 * (noise - np.concatenate([[0.0], noise[:-1]]))  # HF tilt
    if phone in ("k", "t"):
        out = np.zeros(n)
        closure = min(int(0.015 * SR), n)
        burst = min(int(0.025 * SR), n - closure)
        out[closure:closure + burst] = 0.15 * rng.normal(size=burst) * \
            np.linspace(1.0, 0.2, burst)
        return out
    formants = [(fc * formant_scale, amp) for fc, amp in _FORMANTS[phone]]
    amp0 = 0.8 if phone in ("n", "m") else 1.0
    phase0 = 2 * np.pi * np.cumsum(f0) / SR
    f0_mean = float(np.mean(f0))
    seg = np.zeros(n)
    h = 1
    while h * f0_mean < 4500.0:
        amp = _formant_gain(h * f0_mean, formants) / np.sqrt(h)
        seg += amp * np.sin(h * phase0 + 0.07 * h * h)
        h += 1
    seg += 0.004 * rng.normal(size=n)  # aspiration
    peak = np.max(np.abs(seg)) or 1.0
    return amp0 * 0.35 * seg / peak


def synth_utterance_vocal(rng, f0_base, n_phones=8, formant_scale=1.0,
                          phone_weights=None):
    """Speech-like utterance: glottal-pulse + formant phones, F0 declination
    with vibrato and per-phone accents. Unlike the line-spectral tone corpus
    (synth_utterance), its mels have smooth spectral envelopes, so MCD values
    land on the interpretable natural-speech dB scale (tests/test_mcd_gate).

    formant_scale / phone_weights: per-speaker vocal-tract proxy and per-
    language phone distribution (see make_synthetic_corpus voice_variation)."""
    phones, intervals = [], []
    t = 0.15
    segs = [np.zeros(int(t * SR))]
    intervals.append(Interval(0.0, t, "sil"))
    for i in range(n_phones):
        if phone_weights is None:
            p = PHONES[rng.integers(0, len(PHONES))]
        else:
            p = PHONES[rng.choice(len(PHONES), p=phone_weights)]
        dur = float(rng.uniform(0.06, 0.18))
        n = int(dur * SR)
        # declination 1.1 -> 0.9 across the utterance, per-phone accent,
        # 5 Hz vibrato
        decl = 1.1 - 0.2 * (i / max(n_phones - 1, 1))
        accent = float(rng.uniform(0.94, 1.08))
        tt = np.arange(n) / SR
        f0 = f0_base * decl * accent * (1.0 + 0.015 * np.sin(2 * np.pi * 5.0 * tt))
        seg = _vocal_phone(rng, p, n, f0, formant_scale=formant_scale)
        fade = min(128, max(n // 4, 1))
        seg[:fade] *= np.linspace(0, 1, fade)
        seg[-fade:] *= np.linspace(1, 0, fade)
        segs.append(seg)
        phones.append(p)
        intervals.append(Interval(t, t + dur, p))
        t += dur
    tail = 0.12
    segs.append(np.zeros(int(tail * SR)))
    intervals.append(Interval(t, t + tail, "sil"))
    wav = np.concatenate(segs).astype(np.float32)
    return wav, phones, intervals, t + tail


def synth_utterance(rng, f0_base, n_phones=8):
    """Voiced tone with per-phone F0/amplitude steps + silence padding."""
    phones, intervals = [], []
    t = 0.15  # leading silence
    segs = [np.zeros(int(t * SR))]
    intervals.append(Interval(0.0, t, "sil"))
    for i in range(n_phones):
        p = PHONES[rng.integers(0, len(PHONES))]
        dur = float(rng.uniform(0.06, 0.18))
        f0 = f0_base * float(rng.uniform(0.9, 1.15))
        n = int(dur * SR)
        tt = np.arange(n) / SR
        amp = 0.4 * float(rng.uniform(0.6, 1.0))
        seg = amp * (
            np.sin(2 * np.pi * f0 * tt)
            + 0.4 * np.sin(4 * np.pi * f0 * tt)
            + 0.15 * np.sin(6 * np.pi * f0 * tt)
        )
        # fade edges to avoid clicks
        fade = min(128, n // 4)
        seg[:fade] *= np.linspace(0, 1, fade)
        seg[-fade:] *= np.linspace(1, 0, fade)
        segs.append(seg)
        phones.append(p)
        intervals.append(Interval(t, t + dur, p))
        t += dur
    tail = 0.12
    segs.append(np.zeros(int(tail * SR)))
    intervals.append(Interval(t, t + tail, "sil"))
    wav = np.concatenate(segs).astype(np.float32)
    return wav, phones, intervals, t + tail


# per-language phone distributions (vocal style with voice_variation):
# ja favors open vowels + nasals, en favors front vowels + obstruents —
# a learnable language cue for the GE2E DA head and the langemb
# discriminator, standing in for real phonotactics
_LANG_PHONE_WEIGHTS = {
    # PHONES = [a, i, u, e, o, k, s, t, n, m]
    "ja": np.array([3.0, 1.5, 2.5, 1.0, 3.0, 1.0, 0.5, 1.0, 2.0, 2.0]),
    "en": np.array([1.0, 3.0, 0.5, 3.0, 1.0, 2.0, 2.5, 2.5, 1.0, 0.5]),
}


def make_synthetic_corpus(root, n_speakers=2, utts_per_speaker=3, seed=0,
                          dataset="SYNTH", languages=("ja",), speaker_prefix="spk",
                          style="tone", n_phones=(8, 8), voice_variation=False):
    """Create raw_data/<spk>/*.{wav,lab} + preprocessed_data TextGrids +
    accent files + speakers.json. Returns (raw_dir, preprocessed_dir, config).

    style: "tone" (fast line-spectral harmonics — most tests) or "vocal"
    (glottal-pulse + formant speech, smooth spectral envelopes — the MCD
    gate's natural-dB-scale corpus).

    n_phones: (lo, hi) inclusive range of phones per utterance; the default 8
    gives ~1.1 s utterances (test scale), while (24, 40) gives ~3-5 s —
    reference-corpus-shaped (JSUT averages ~4 s/utt).

    voice_variation (vocal style): gives every speaker a DISTINCT voice —
    per-speaker f0_base jitter (M 105-145 Hz, F 185-235 Hz) and a
    vocal-tract-length formant scale (0.88-1.12) — and every language a
    distinct phone distribution (_LANG_PHONE_WEIGHTS). Without it, all
    same-gender speakers are acoustically identical, so speaker-
    verification (GE2E/EER) and language-discrimination tasks are
    unlearnable by construction (measured r5: 64-speaker GE2E plateaued at
    chance-within-gender, held-out EER 26%, DA accuracy 47%)."""
    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "raw_data", dataset)
    pre = os.path.join(root, "preprocessed_data", dataset)
    os.makedirs(os.path.join(pre, "accent"), exist_ok=True)

    speakers = {}
    for s in range(n_speakers):
        spk = f"{speaker_prefix}{s:02d}"
        gender = "M" if s % 2 == 0 else "F"
        lang = languages[s % len(languages)]
        speakers[spk] = [s, gender, lang]
        spk_raw = os.path.join(raw, spk)
        tg_dir = os.path.join(pre, "TextGrid", spk)
        os.makedirs(spk_raw, exist_ok=True)
        os.makedirs(tg_dir, exist_ok=True)
        f0_base = 120.0 if gender == "M" else 210.0
        synth_kwargs = {}
        if voice_variation:
            assert style == "vocal", "voice_variation needs the vocal style"
            f0_base = (float(rng.uniform(105.0, 145.0)) if gender == "M"
                       else float(rng.uniform(185.0, 235.0)))
            w = _LANG_PHONE_WEIGHTS[lang]
            # formant scale (vocal-tract length proxy) CORRELATES with
            # gender, as in real speech — male tracts are longer (lower
            # formants). An uncorrelated scale leaves F0 as the only gender
            # cue, and with per-speaker F0 jitter the speaker-embedding
            # space then organizes by speaker F0 continuum rather than by
            # gender (measured r5 at 104 speakers: inter-gender centroid
            # distance 1.43 < intra-gender spread 1.92, so corner-GMM
            # samples were gender-ambiguous)
            synth_kwargs = {
                "formant_scale": (float(rng.uniform(0.86, 0.98))
                                  if gender == "M"
                                  else float(rng.uniform(1.02, 1.14))),
                "phone_weights": w / w.sum(),
            }
        for u in range(utts_per_speaker):
            base = f"{spk}_utt{u:02d}"
            synth = synth_utterance_vocal if style == "vocal" else synth_utterance
            np_lo, np_hi = n_phones
            wav, phones, intervals, total = synth(
                rng, f0_base, n_phones=int(rng.integers(np_lo, np_hi + 1)),
                **synth_kwargs)
            write_wav(os.path.join(spk_raw, base + ".wav"), wav, SR)
            with open(os.path.join(spk_raw, base + ".lab"), "w") as f:
                f.write(" ".join(phones) + "\n")
            tg = TextGrid(tiers=[Tier(name="phones", intervals=intervals)])
            write_textgrid(os.path.join(tg_dir, base + ".TextGrid"), tg, 0.0, total)
            with open(os.path.join(pre, "accent", base + ".accent"), "w") as f:
                f.write("0" * len(phones))

    with open(os.path.join(pre, "speakers.json"), "w") as f:
        json.dump(speakers, f)

    config = {
        "dataset": dataset,
        "path": {"raw_path": raw, "preprocessed_path": pre},
        "preprocessing": {
            "val_size": 0.2,
            "test_size": 0.2,
            "audio": {"sampling_rate": SR, "max_wav_value": 32768.0},
            "stft": {"filter_length": 1024, "hop_length": 256, "win_length": 1024},
            "mel": {"n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": 8000},
            "pitch": {"feature": "phoneme_level", "normalization": True},
            "energy": {"feature": "phoneme_level", "normalization": True},
            "speaker_generation": {
                "metadata": {"gender": {"M": 0, "F": 1}, "language": {"ja": 0, "en": 1}}
            },
        },
        "text": {"text_cleaners": [], "language": "ja"},
        "accent": {"use_accent": True},
    }
    return raw, pre, config


# ---------------------------------------------------------------------------
# copied from masg_tpu/data/synthetic.py:261-359 (the demos' experiment dir)
# ---------------------------------------------------------------------------


def make_config_dir(root, pre_dir, tmp, *, dataset="SYNTH", batch_size=2,
                    group_size=2, total_step=20, log_step=5, synth_step=1000,
                    val_step=10, save_step=10, grad_acc_step=1, warm_up_step=20,
                    out_subdir="out", use_jdit=False, discriminator_path=None,
                    lambd=None):
    """Write a reference-style experiment config dir for the fixture corpus
    (masg_tpu/data/synthetic.py:261; the same arguments and the same YAML)."""
    import yaml

    cfg_dir = os.path.join(tmp, "config")
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "preprocess.yaml"), "w") as f:
        yaml.dump({
            "val_size": 0.2, "test_size": 0.2,
            "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
            "stft": {"filter_length": 1024, "hop_length": 256, "win_length": 1024},
            "mel": {"n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": 8000},
            "pitch": {"feature": "phoneme_level", "normalization": True},
            "energy": {"feature": "phoneme_level", "normalization": True},
            "speaker_generation": {"metadata": {
                "gender": {"M": 0, "F": 1}, "language": {"ja": 0, "en": 1}}},
        }, f)
    with open(os.path.join(cfg_dir, "model.yaml"), "w") as f:
        yaml.dump({
            "transformer": {
                "encoder_layer": 2, "encoder_head": 2, "encoder_hidden": 64,
                "decoder_layer": 2, "decoder_head": 2, "decoder_hidden": 64,
                "conv_filter_size": 128, "conv_kernel_size": [9, 1],
                "encoder_dropout": 0.2, "decoder_dropout": 0.2,
            },
            "variance_predictor": {"filter_size": 64, "kernel_size": 3, "dropout": 0.5},
            "variance_embedding": {"pitch_quantization": "linear",
                                   "energy_quantization": "linear", "n_bins": 256},
            # a tiny Tacotron2 teacher, as masg_tpu's tests and demos size it
            "jdit": {"use_jdit": use_jdit, "prenet_hidden": 32,
                     "attention_rnn_dim": 48, "decoder_rnn_dim": 48,
                     "attention_dim": 16, "location_filters": 4,
                     "location_kernel": 7},
            "multi_speaker": True,
            "max_seq_len": 1000,
            "vocoder": {"model": "HiFi-GAN", "speaker": "universal"},
            "speaker_generation": {"GMM_mixtures": 3},
            "discriminator": {"hidden": 64},
        }, f)
    with open(os.path.join(cfg_dir, "train.yaml"), "w") as f:
        train_yaml = {
            "path": {
                "ckpt_path": os.path.join(tmp, out_subdir, "ckpt"),
                "log_path": os.path.join(tmp, out_subdir, "log"),
                "result_path": os.path.join(tmp, out_subdir, "result"),
            },
            "optimizer": {
                "batch_size": batch_size, "betas": [0.9, 0.98], "eps": 1e-9,
                "weight_decay": 0.0, "grad_clip_thresh": 1.0,
                "grad_acc_step": grad_acc_step,
                "warm_up_step": warm_up_step, "anneal_steps": [], "anneal_rate": 0.3,
            },
            "step": {"total_step": total_step, "log_step": log_step,
                     "synth_step": synth_step, "val_step": val_step,
                     "save_step": save_step},
            "dataparallel": False,
            "group_size": group_size,
        }
        if discriminator_path is not None:  # reference train.yaml:6
            train_yaml["discriminator_path"] = discriminator_path
        if lambd is not None:
            train_yaml["lambda"] = lambd
        yaml.dump(train_yaml, f)
    with open(os.path.join(cfg_dir, f"preprocess_{dataset}.yaml"), "w") as f:
        yaml.dump({
            "dataset": dataset,
            "path": {"raw_path": os.path.join(root, "raw_data", dataset),
                     "preprocessed_path": pre_dir},
            "text": {"text_cleaners": [], "language": "ja"},
            "accent": {"use_accent": True},
        }, f)
    return cfg_dir


def build_synthetic_experiment_dir(tmp, *, n_speakers=2, utts_per_speaker=6,
                                   seed=0, style="tone", languages=("ja",),
                                   voice_variation=False, n_phones=(8, 8),
                                   device="cuda", **config_kwargs):
    """Corpus + preprocess + config dir in one call (masg_tpu/data/
    synthetic.py:340); `cli.preprocess` runs on `device`. Returns cfg_dir."""
    from ..cli.preprocess import main as preprocess_main

    _, pre, _ = make_synthetic_corpus(
        tmp, n_speakers=n_speakers, utts_per_speaker=utts_per_speaker, seed=seed,
        style=style, languages=languages, voice_variation=voice_variation,
        n_phones=n_phones,
    )
    cfg_dir = make_config_dir(tmp, pre, tmp, **config_kwargs)
    preprocess_main(["--config", cfg_dir, "--device", str(device)])
    # single corpus: copy its stats into the config dir (gather is for multi)
    shutil.copy(os.path.join(pre, "stats.json"), os.path.join(cfg_dir, "stats.json"))
    shutil.copy(os.path.join(pre, "speakers.json"), os.path.join(cfg_dir, "speakers.json"))
    return cfg_dir
