# `hann_window` and `mel_filterbank` are copied from masg_tpu/audio/stft.py (numpy, no JAX);
# `stft_magnitude` and `mel_spectrogram_and_energy` are its torch counterparts.
"""STFT magnitude, the slaney mel filterbank and the FastSpeech2 features
(port of masg_tpu/audio/stft.py).

Numerically the reference's torchaudio stack (preprocessor/preprocessor.py:
44-59): Spectrogram(n_fft=1024, win=1024, hop=256, power=1, center=True,
pad_mode='reflect', periodic Hann window), MelScale(slaney norm and scale),
log(clamp_min(mel, 1e-5)); energy = ||magnitude||_2 per frame.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann (torch.hann_window default)."""
    n = np.arange(win_length)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = 80,
    n_fft: int = 1024,
    sample_rate: int = 22050,
    f_min: float = 0.0,
    f_max: float = 8000.0,
) -> np.ndarray:
    """(n_fft//2+1, n_mels) slaney-scale, slaney-normalized triangular filters.

    Matches torchaudio MelScale(norm='slaney', mel_scale='slaney') /
    librosa.filters.mel(htk=False, norm='slaney').
    """

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = 3.0 * f / 200.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz * 3.0 / 200.0
        logstep = np.log(6.4) / 27.0
        with np.errstate(divide="ignore"):
            log_branch = min_log_mel + np.log(
                np.where(f > 0, f, 1.0) / min_log_hz
            ) / logstep
        return np.where(f >= min_log_hz, log_branch, mel)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = 200.0 * m / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz * 3.0 / 200.0
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)

    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)

    f_diff = np.diff(f_pts)  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    # slaney norm: scale each filter by 2 / bandwidth
    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def stft_magnitude(audio: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                   win_length: int = 1024, center: bool = True,
                   pad_to: Optional[int] = None) -> torch.Tensor:
    """|STFT| of (..., T) audio -> (..., n_freqs, n_frames), power=1.

    center=True reflect-pads n_fft//2 on both sides (torch.stft semantics);
    `pad_to` then zero-pads the padded signal out to pad_to + n_fft samples,
    so every frame inside the reflect-padded extent keeps its value (the
    extra tail frames read zeros), as masg_tpu's length bucketing does.
    """
    window = torch.as_tensor(hann_window(win_length), dtype=audio.dtype, device=audio.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    lead = audio.shape[:-1]
    x = audio.reshape(-1, 1, audio.shape[-1])
    if center:
        x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    if pad_to is not None:
        target = pad_to + (n_fft if center else 0)
        if target < x.shape[-1]:
            raise ValueError(f"pad_to {pad_to} < audio length {x.shape[-1]}")
        x = F.pad(x, (0, target - x.shape[-1]))
    frames = x[:, 0].unfold(-1, n_fft, hop_length) * window  # (N, n_frames, n_fft)
    mag = torch.fft.rfft(frames, dim=-1).abs()
    return mag.transpose(-1, -2).reshape(*lead, n_fft // 2 + 1, -1)


def mel_spectrogram_and_energy(audio: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                               win_length: int = 1024, n_mels: int = 80,
                               sample_rate: int = 22050, f_min: float = 0.0,
                               f_max: float = 8000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., T) audio -> (log-mel (..., n_mels, frames), energy (..., frames)),
    frames = 1 + T // hop (reference calc_spectrogram, preprocessor.py:
    330-336): audio clipped to [-1, 1], the magnitude STFT, the slaney mel,
    log(clamp_min(1e-5)); energy is the L2 norm over frequency. masg_tpu's
    `pad_to` (length buckets that reuse XLA compiles) has no counterpart."""
    mag = stft_magnitude(torch.clamp(audio, -1.0, 1.0), n_fft, hop_length, win_length)
    fb = torch.as_tensor(mel_filterbank(n_mels, n_fft, sample_rate, f_min, f_max)).to(
        mag.device, mag.dtype)
    mel = torch.einsum("...ft,fm->...mt", mag, fb)
    return torch.log(torch.clamp(mel, min=1e-5)), torch.sqrt(torch.sum(mag * mag, dim=-2))
