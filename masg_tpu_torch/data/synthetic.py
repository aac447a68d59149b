"""A random preprocessed corpus and a config dir for it, written with numpy.

For smoke runs and tests of the training path without audio or
preprocessing: the files are laid out as the preprocessor writes them and
`data.dataset.Dataset` reads them (`speakers.json`, `train.txt`/`val.txt`
with `basename|speaker|{phones}|raw_text` lines, `mel|pitch|energy|duration/
<speaker>-<kind>-<basename>.npy`, `stats.json`), with random features.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

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
                     dataset: str = "SYNTH", train: Optional[Dict[str, Any]] = None) -> str:
    """A reference-style config dir for the corpus in `pre_dir`, writing
    checkpoints and logs under `out_dir`. `model` is model.yaml (empty: the
    flagship `ModelConfig()` defaults); `optimizer` and `step` update
    train.yaml's sections, `train` its top level (e.g. `discriminator_path`,
    `lambda`)."""
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
    corpus = {"dataset": dataset, "path": {"raw_path": "", "preprocessed_path": pre_dir},
              "text": {"text_cleaners": [], "language": "ja"}, "accent": {"use_accent": False}}
    for name, doc in (("preprocess.yaml", preprocess), ("model.yaml", model or {}),
                      ("train.yaml", train), (f"preprocess_{dataset}.yaml", corpus)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.safe_dump(doc, f)
    for name in ("stats.json", "speakers.json"):
        shutil.copy(os.path.join(pre_dir, name), os.path.join(cfg_dir, name))
    return cfg_dir
