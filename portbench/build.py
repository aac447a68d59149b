"""A configuration's weights, speakers and the program's objects.

The weights are made here from the seed, on the device, and handed to the
program (which loads them with `strict=True`) and to the plain reference
alike. The program is built through its own entry points: its
`FastSpeech2.from_config`, `infer.vocoder.build_generator` and `Vocoder`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.harness import make_weights
from portbench.reference import fastspeech2 as ref_fs2
from portbench.reference import hifigan as ref_hifigan


def speakers(config: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(gender, language) index of each table speaker: the first
    `speakers.ja` speak Japanese, the rest English; genders alternate."""
    n_ja, n = config["speakers"]["ja"], config["n_speakers"]
    ids = np.arange(n)
    return ids % 2, (ids >= n_ja).astype(np.int64)


def speaker_meta(config: dict, ids: np.ndarray) -> np.ndarray:
    """The (n, 4) one-hot [M, F, ja, en] rows of table speakers `ids`."""
    gender, lang = speakers(config)
    meta = np.zeros((len(ids), 4), np.float32)
    meta[np.arange(len(ids)), gender[ids]] = 1.0
    meta[np.arange(len(ids)), 2 + lang[ids]] = 1.0
    return meta


def fs2_spec(config: dict):
    return ref_fs2.spec(config["model"], config["n_symbols"], config["n_speakers"],
                        config["preprocess"]["mel"]["n_mel_channels"], meta_dim=4)


def fs2_weights(config: dict, gen: torch.Generator, device: str) -> Dict[str, torch.Tensor]:
    """FastSpeech2's state dict from `gen`. The duration predictor's output
    is set so that log(1 + d) has the mean and spread the configuration
    assumes (random weights would give durations near zero)."""
    m, st = config["model"], config["stats"]
    d_inner = m["variance_predictor"]["filter_size"]
    a = config["assumed"]
    sigma = a["log_duration_sigma"]
    n_bins = m["variance_embedding"]["n_bins"]

    def full(v):
        return lambda shape: torch.full(shape, float(v), device=device)

    fills = {
        "ones": full(1.0),
        "count": lambda shape: torch.zeros(shape, dtype=torch.long, device=device),
        "sinusoid": lambda shape: torch.from_numpy(
            ref_fs2.sinusoid(shape[1], shape[2])).to(device)[None],
        "pitch_bins": lambda shape: torch.from_numpy(
            ref_fs2.bins(st["pitch"][0], st["pitch"][1], n_bins)).to(device),
        "energy_bins": lambda shape: torch.from_numpy(
            ref_fs2.bins(st["energy"][0], st["energy"][1], n_bins)).to(device),
        # E[exp(N(mu, sigma^2))] = exp(mu + sigma^2 / 2) = 1 + frames per phone
        "duration_bias": full(math.log(1.0 + a["frames_per_phone"]) - sigma ** 2 / 2),
    }
    fills["duration_out"] = lambda shape: (
        torch.randn(shape, generator=gen, device=device) * sigma / math.sqrt(d_inner))
    return make_weights(fs2_spec(config), gen, device, fills)


def vocoder_weights(config: dict, gen: torch.Generator, device: str) -> Dict[str, torch.Tensor]:
    return make_weights(ref_hifigan.spec(config["vocoder"]), gen, device, {})


def weights(config: dict, seed: int, device: str, vocoder: bool = True):
    """(FastSpeech2 state dict, vocoder state dict or None) made from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fs2 = fs2_weights(config, gen, device)
    return fs2, vocoder_weights(config, gen, device) if vocoder else None


def port_config(config: dict):
    """The program's ExperimentConfig for this configuration."""
    from masg_tpu_torch.core.config import (ExperimentConfig, ModelConfig, PreprocessConfig,
                                            Stats, TrainConfig)

    gender, lang = speakers(config)
    return ExperimentConfig(
        preprocess=PreprocessConfig.from_dict(config["preprocess"]),
        model=ModelConfig.from_dict(config["model"]), train=TrainConfig(),
        stats=Stats(pitch=tuple(config["stats"]["pitch"]),
                    energy=tuple(config["stats"]["energy"])),
        speakers={f"spk{i}": [i, "MF"[gender[i]], ("ja", "en")[lang[i]]]
                  for i in range(config["n_speakers"])})


def port_fs2(config: dict, sd: Dict[str, torch.Tensor], device: str, use_flash: bool = True):
    """The program's FastSpeech2 holding `sd`, in eval mode."""
    from masg_tpu_torch.models.fastspeech2 import FastSpeech2

    with torch.device(device):
        model = FastSpeech2.from_config(port_config(config), use_flash=use_flash)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def port_vocoder(config: dict, sd: Dict[str, torch.Tensor], device: str):
    """The program's HiFi-GAN `Vocoder` holding `sd` (MRF stages of at most
    64 channels through its fused kernel)."""
    from masg_tpu_torch.infer.vocoder import Vocoder, build_generator

    with torch.device(device):
        gen = build_generator(config["vocoder"], fused_mrf=True)
    gen.load_state_dict(sd, strict=True)
    return Vocoder(gen, hop_length=config["preprocess"]["stft"]["hop_length"])
