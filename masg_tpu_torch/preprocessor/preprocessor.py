"""Offline feature extraction (port of masg_tpu/preprocessor/preprocessor.py):
raw_data/<spk>/*.wav + TextGrid alignments -> mel/pitch/energy/duration .npy
+ stats.json + {train,val,test}.txt.

The reference pipeline (preprocessor/preprocessor.py:16-336) step for step,
with masg_tpu's outputs: the same file names and layouts, the same
`random`-seeded splits, outlier removal and phoneme averaging. The STFT, mel
and energy run through `audio/stft.py:mel_spectrogram_and_energy` on
`device` (the card unless the caller asks for the CPU; masg_tpu pins this
work to its host), one utterance at a time at its own length; F0 (DIO +
StoneMask, the C++ extension) stays on the host. `Preprocessor.seconds`
splits the wall of `build_from_path` into its parts on the host's clock.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..audio.f0 import extract_f0
from ..audio.stft import mel_spectrogram_and_energy
from ..audio.wavio import read_wav, resample_kaiser
from ..device import DeviceLike, resolve_device
from .textgrid import read_textgrid

SIL_PHONES = ["sil", "sp", "spn", "silB", "silE", ""]


class RunningStats:
    """StandardScaler.partial_fit equivalent (mean/std accumulation)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, values: np.ndarray):
        for batch_mean, batch_var, m in [(values.mean(), values.var(), len(values))]:
            if m == 0:
                return
            delta = batch_mean - self.mean
            tot = self.n + m
            self.mean += delta * m / tot
            self.m2 += batch_var * m + delta ** 2 * self.n * m / tot
            self.n = tot

    @property
    def std(self) -> float:
        return float(np.sqrt(self.m2 / self.n)) if self.n else 1.0


class Preprocessor:
    def __init__(self, config: dict, device: DeviceLike = None):
        """config: reference-shaped dict (corpus config with shared
        'preprocessing' grafted under it, see reference preprocess.py:17-30);
        `device` runs the STFT (the card when None)."""
        self.config = config
        self.device = resolve_device(device)
        # seconds of build_from_path by part: TextGrid, wav and text reads; F0 on the host;
        # the STFT, mel and energy on `device` up to their copy back; phoneme averaging and
        # the .npy writes; the pitch and energy normalization pass; and the whole wall
        self.seconds = dict.fromkeys(("read", "f0", "features", "write", "normalize",
                                      "total"), 0.0)
        self.n_utterances = 0
        self.in_dir = config["path"]["raw_path"]
        self.out_dir = config["path"]["preprocessed_path"]
        pp = config["preprocessing"]
        self.val_size = pp["val_size"]
        self.test_size = pp["test_size"]
        self.sampling_rate = pp["audio"]["sampling_rate"]
        self.hop_length = pp["stft"]["hop_length"]
        self.filter_length = pp["stft"]["filter_length"]
        self.win_length = pp["stft"]["win_length"]
        self.n_mels = pp["mel"]["n_mel_channels"]
        self.mel_fmin = pp["mel"]["mel_fmin"]
        self.mel_fmax = pp["mel"]["mel_fmax"]

        assert pp["pitch"]["feature"] in ["phoneme_level", "frame_level"]
        assert pp["energy"]["feature"] in ["phoneme_level", "frame_level"]
        self.pitch_phoneme_averaging = pp["pitch"]["feature"] == "phoneme_level"
        self.energy_phoneme_averaging = pp["energy"]["feature"] == "phoneme_level"
        self.pitch_normalization = pp["pitch"]["normalization"]
        self.energy_normalization = pp["energy"]["normalization"]

        self.mel_kwargs = dict(
            n_fft=self.filter_length, hop_length=self.hop_length,
            win_length=self.win_length, n_mels=self.n_mels, sample_rate=self.sampling_rate,
            f_min=self.mel_fmin,
            f_max=self.mel_fmax if self.mel_fmax else self.sampling_rate / 2)

    # ------------------------------------------------------------------
    def build_from_path(self) -> List[List[str]]:
        t_start = time.perf_counter()
        for sub in ("mel", "pitch", "energy", "duration"):
            os.makedirs(os.path.join(self.out_dir, sub), exist_ok=True)

        out: List[List[str]] = []
        n_frames = 0
        pitch_scaler = RunningStats()
        energy_scaler = RunningStats()

        for speaker in sorted(os.listdir(self.in_dir)):
            spk_dir = os.path.join(self.in_dir, speaker)
            if not os.path.isdir(spk_dir):
                continue
            out_spk: List[str] = []
            for wav_name in sorted(os.listdir(spk_dir)):
                if ".wav" not in wav_name:
                    continue
                basename = wav_name.split(".")[0]
                tg_path = os.path.join(
                    self.out_dir, "TextGrid", speaker, f"{basename}.TextGrid"
                )
                if not os.path.exists(tg_path):
                    raise ValueError(tg_path)
                ret = self.process_utterance(speaker, basename)
                if ret is None:
                    continue
                info, pitch, energy, n = ret
                out_spk.append(info)
                if len(pitch) > 0:
                    pitch_scaler.update(pitch.reshape(-1))
                if len(energy) > 0:
                    energy_scaler.update(energy.reshape(-1))
                n_frames += n
            out.append(out_spk)

        if self.pitch_normalization:
            pitch_mean, pitch_std = pitch_scaler.mean, pitch_scaler.std
        else:
            pitch_mean, pitch_std = 0.0, 1.0
        if self.energy_normalization:
            energy_mean, energy_std = energy_scaler.mean, energy_scaler.std
        else:
            energy_mean, energy_std = 0.0, 1.0

        t0 = time.perf_counter()
        pitch_min, pitch_max = self._normalize_dir(
            os.path.join(self.out_dir, "pitch"), pitch_mean, pitch_std
        )
        energy_min, energy_max = self._normalize_dir(
            os.path.join(self.out_dir, "energy"), energy_mean, energy_std
        )
        self.seconds["normalize"] += time.perf_counter() - t0

        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump(
                {
                    "pitch": [float(pitch_min), float(pitch_max), float(pitch_mean), float(pitch_std)],
                    "energy": [float(energy_min), float(energy_max), float(energy_mean), float(energy_std)],
                },
                f,
            )

        print(
            "Total time: {} hours".format(
                n_frames * self.hop_length / self.sampling_rate / 3600
            )
        )

        # per-speaker shuffled fractional splits (reference :149-165)
        random.shuffle(out)
        for r in out:
            random.shuffle(r)
        out = [[r_ for r_ in r if r_ is not None] for r in out]

        def write_split(name, lo_frac, hi_frac):
            with open(os.path.join(self.out_dir, name), "w", encoding="utf-8") as f:
                for spk in out:
                    lo = int(len(spk) * lo_frac)
                    hi = int(len(spk) * hi_frac) if hi_frac is not None else len(spk)
                    for m in spk[lo:hi]:
                        f.write(m + "\n")

        train_frac = 1 - self.val_size - self.test_size
        write_split("train.txt", 0.0, None if train_frac >= 1 else train_frac)
        if train_frac < 1:
            write_split("val.txt", train_frac, 1 - self.test_size)
            write_split("test.txt", 1 - self.test_size, None)
        else:
            # no validation fraction: empty splits (reference spk[len:] slices)
            write_split("val.txt", 1.0, None)
            write_split("test.txt", 1.0, None)
        self.seconds["total"] += time.perf_counter() - t_start
        return out

    # ------------------------------------------------------------------
    def process_utterance(
        self, speaker: str, basename: str
    ) -> Optional[Tuple[str, np.ndarray, np.ndarray, int]]:
        wav_path = os.path.join(self.in_dir, speaker, f"{basename}.wav")
        text_path = os.path.join(self.in_dir, speaker, f"{basename}.lab")
        tg_path = os.path.join(self.out_dir, "TextGrid", speaker, f"{basename}.TextGrid")

        t0 = time.perf_counter()
        textgrid = read_textgrid(tg_path)
        phone, duration, start, end = self.get_alignment(
            textgrid.get_tier_by_name("phones")
        )
        text = "{" + " ".join(phone) + "}"
        if start >= end:
            return None

        wav, sr = read_wav(wav_path)
        if sr != self.sampling_rate:
            # anti-aliased Kaiser polyphase (librosa.load-equivalent quality)
            wav = resample_kaiser(wav, sr, self.sampling_rate)
        wav = wav[
            int(self.sampling_rate * start) : int(self.sampling_rate * end)
        ].astype(np.float32)

        raw_text = ""
        if os.path.exists(text_path):
            with open(text_path) as f:
                raw_text = f.readline().strip("\n")
        t1 = time.perf_counter()
        self.seconds["read"] += t1 - t0

        # F0 (DIO + StoneMask) at frame_period = hop/sr * 1000
        pitch = extract_f0(
            wav.astype(np.float64),
            self.sampling_rate,
            frame_period=self.hop_length / self.sampling_rate * 1000,
        )
        pitch = pitch[: sum(duration)]
        t0 = time.perf_counter()
        self.seconds["f0"] += t0 - t1
        if np.sum(pitch != 0) <= 1:
            return None

        with torch.inference_mode():
            logmel, energy = mel_spectrogram_and_energy(
                torch.from_numpy(wav).to(self.device), **self.mel_kwargs)
            mel = logmel.cpu().numpy()[:, : sum(duration)]
            energy = energy.cpu().numpy()[: sum(duration)]
        t1 = time.perf_counter()
        self.seconds["features"] += t1 - t0

        if self.pitch_phoneme_averaging:
            # linear-interp unvoiced gaps, then per-phoneme means (:212-231)
            nonzero_ids = np.where(pitch != 0)[0]
            pitch = np.interp(
                np.arange(len(pitch)), nonzero_ids, pitch[nonzero_ids]
            )
            pos = 0
            for i, d in enumerate(duration):
                pitch[i] = np.mean(pitch[pos : pos + d]) if d > 0 else 0.0
                pos += d
            pitch = pitch[: len(duration)]

        if self.energy_phoneme_averaging:
            pos = 0
            for i, d in enumerate(duration):
                energy[i] = np.mean(energy[pos : pos + d]) if d > 0 else 0.0
                pos += d
            energy = energy[: len(duration)]

        np.save(os.path.join(self.out_dir, "duration", f"{speaker}-duration-{basename}.npy"), duration)
        np.save(os.path.join(self.out_dir, "pitch", f"{speaker}-pitch-{basename}.npy"), pitch)
        np.save(os.path.join(self.out_dir, "energy", f"{speaker}-energy-{basename}.npy"), energy)
        np.save(os.path.join(self.out_dir, "mel", f"{speaker}-mel-{basename}.npy"), mel.T)
        self.seconds["write"] += time.perf_counter() - t1
        self.n_utterances += 1

        return (
            "|".join([basename, speaker, text, raw_text]),
            self.remove_outlier(pitch),
            self.remove_outlier(energy),
            mel.shape[1],
        )

    # ------------------------------------------------------------------
    def get_alignment(self, tier) -> Tuple[List[str], List[int], float, float]:
        """TextGrid phones tier -> (phones, frame durations, start, end).
        Reference :267-305: trims leading/trailing silences, maps interior
        silences to 'sp', rounds interval edges to frames."""
        phones: List[str] = []
        durations: List[int] = []
        start_time = 0.0
        end_time = 0.0
        end_idx = 0
        for t in tier._objects:
            s, e, p = t.start_time, t.end_time, t.text
            if phones == []:
                if p in SIL_PHONES:
                    continue
                start_time = s
            if p not in SIL_PHONES:
                phones.append(p)
                end_time = e
                end_idx = len(phones)
            else:
                phones.append("sp")
            durations.append(
                int(
                    np.round(e * self.sampling_rate / self.hop_length)
                    - np.round(s * self.sampling_rate / self.hop_length)
                )
            )
        phones = phones[:end_idx]
        durations = durations[:end_idx]
        assert len(phones) == len(durations)
        return phones, durations, start_time, end_time

    @staticmethod
    def remove_outlier(values: np.ndarray) -> np.ndarray:
        """IQR 1.5 clip, used only for scaler statistics (:307-315)."""
        values = np.array(values)
        p25, p75 = np.percentile(values, 25), np.percentile(values, 75)
        lower = p25 - 1.5 * (p75 - p25)
        upper = p75 + 1.5 * (p75 - p25)
        return values[np.logical_and(values > lower, values < upper)]

    @staticmethod
    def _normalize_dir(in_dir: str, mean: float, std: float) -> Tuple[float, float]:
        max_value = np.finfo(np.float64).min
        min_value = np.finfo(np.float64).max
        for filename in os.listdir(in_dir):
            filename = os.path.join(in_dir, filename)
            values = (np.load(filename) - mean) / std
            np.save(filename, values)
            max_value = max(max_value, max(values))
            min_value = min(min_value, min(values))
        return min_value, max_value
