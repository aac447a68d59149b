"""GE2E speaker-encoder data prep (port of masg_tpu/preprocessor/ge2e_preprocess.py):
VAD-split wavs -> 150-frame log-mel chunk archives named
`{dataset}_{spkr}_{gender}_{lang}.npy`.

Reference: Multilingual-Speaker-Encoder-with-Domain-Adaptation/
data_preprocess.py:39-119 (librosa.effects.split VAD -> utterance mel chunks)
+ utils.py:266-274 (mel_spectrogram: |STFT| -> mel fmin 55 fmax 8000 ->
log(clip 1e-5)). The VAD is an energy-threshold splitter equivalent to
librosa.effects.split(top_db). The STFT runs in torch on the CPU
(`audio/stft.py`); masg_tpu's `core/hostcompute.on_host` (CPU pinning of its
JAX STFT) has no counterpart.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..audio.stft import mel_filterbank, stft_magnitude
from ..audio.wavio import read_wav, resample_kaiser


def energy_split(
    wav: np.ndarray,
    top_db: float = 30.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> List[Tuple[int, int]]:
    """librosa.effects.split equivalent: non-silent [start, end) sample spans
    where frame RMS is within top_db of the max."""
    n = len(wav)
    if n < frame_length:
        return [(0, n)] if n else []
    n_frames = 1 + (n - frame_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=1) + 1e-12)
    db = 20.0 * np.log10(rms + 1e-12)
    non_silent = db > (db.max() - top_db)

    spans = []
    start = None
    for i, v in enumerate(non_silent):
        if v and start is None:
            start = i
        elif not v and start is not None:
            spans.append((start * hop_length, min(i * hop_length + frame_length, n)))
            start = None
    if start is not None:
        spans.append((start * hop_length, n))
    # merge adjacent/overlapping spans
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def ge2e_mel(wav: np.ndarray, sr: int = 22050, n_fft: int = 1024,
             hop: int = 256, win: int = 1024, n_mels: int = 80) -> np.ndarray:
    """log-mel with fmin 55 / fmax 8000 (reference utils.py mel_spectrogram;
    note: center=False uncentered STFT in librosa.core.stft default is
    center=True — reference uses the default, so center-padded)."""
    mag = stft_magnitude(torch.from_numpy(np.ascontiguousarray(wav, np.float32)),
                         n_fft, hop, win).numpy()
    fb = mel_filterbank(n_mels, n_fft, sr, 55.0, 8000.0)
    mel = fb.T @ mag
    return np.log(np.clip(mel, 1e-5, None))


def chunk_speaker_wavs(
    wav_paths: List[str],
    sr: int = 22050,
    tisv_frame: int = 150,
    hop: int = 256,
    stride: int = None,
) -> np.ndarray:
    """All speaker wavs -> (n_chunks, n_mels, tisv_frame) archive.

    stride (default tisv_frame//2): slide a window with this frame stride
    across each VAD span — the reference data prep's policy is the 50%-
    overlap window (data_preprocess.py:64-66 advances `i += 0.5` frames per
    window). stride=0: a simplified endpoints-only mode (one chunk from each
    end of every span) that yields fewer chunks than the reference."""
    if stride is None:
        stride = tisv_frame // 2
    chunks = []
    min_samples = tisv_frame * hop
    for p in wav_paths:
        wav, fsr = read_wav(p)
        if fsr != sr:
            wav = resample_kaiser(wav, fsr, sr)
        for s, e in energy_split(wav):
            seg = wav[s:e]
            if len(seg) < min_samples:
                continue
            mel = ge2e_mel(seg, sr=sr, hop=hop)  # (n_mels, T)
            if stride > 0:
                for i in range(0, mel.shape[1] - tisv_frame + 1, stride):
                    chunks.append(mel[:, i:i + tisv_frame])
            else:
                chunks.append(mel[:, :tisv_frame])
                if mel.shape[1] >= 2 * tisv_frame:
                    chunks.append(mel[:, -tisv_frame:])
    if not chunks:
        return np.zeros((0, 80, tisv_frame), np.float32)
    return np.stack(chunks).astype(np.float32)


def build_ge2e_corpus(
    speakers: Dict[str, Tuple[List[str], str, str]],
    out_dir: str,
    dataset: str,
    sr: int = 22050,
    stride: int = None,
) -> List[str]:
    """speakers: name -> (wav paths, gender, language). Writes
    `{dataset}_{spkr}_{gender}_{lang}.npy` per speaker (reference filename
    contract, data_load.py:88-90)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for spk, (paths, gender, lang) in speakers.items():
        arr = chunk_speaker_wavs(paths, sr=sr, stride=stride)
        if arr.shape[0] == 0:
            continue
        fn = f"{dataset.lower()}_{spk}_{gender}_{lang}.npy"
        np.save(os.path.join(out_dir, fn), arr)
        written.append(fn)
    return written
