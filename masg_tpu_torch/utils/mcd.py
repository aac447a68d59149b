"""Mel-cepstral distortion (MCD) (a copy of masg_tpu/utils/mcd.py).

MCD between two log-mel sequences: convert each frame's log-mel vector to
mel-cepstral coefficients via DCT-II, drop c0 (energy), and average the
frame-wise euclidean distance with the standard 10*sqrt(2)/ln(10) scaling.
Frames are aligned by plain truncation or DTW (`align='dtw'`). numpy only.
"""

from __future__ import annotations

import numpy as np

MCD_CONST = 10.0 * np.sqrt(2.0) / np.log(10.0)


def _dct_matrix(n_mfc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis (n_mfc, n_mels)."""
    k = np.arange(n_mfc)[:, None]
    n = np.arange(n_mels)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels))
    basis[0] *= 1.0 / np.sqrt(2.0)
    return basis * np.sqrt(2.0 / n_mels)


def mel_to_mcep(logmel: np.ndarray, n_mfc: int = 13) -> np.ndarray:
    """(T, n_mels) log-mel -> (T, n_mfc) mel-cepstra (c0 included)."""
    logmel = np.asarray(logmel)
    basis = _dct_matrix(n_mfc, logmel.shape[-1])
    return logmel @ basis.T


def mcd(
    logmel_a: np.ndarray,
    logmel_b: np.ndarray,
    n_mfc: int = 13,
    align: str = "truncate",
) -> float:
    """MCD in dB between (T, n_mels) log-mel spectrograms.

    align='truncate' compares the overlapping frames; align='dtw' warps b
    onto a with a standard cumulative-cost path first.
    """
    ca = mel_to_mcep(logmel_a, n_mfc)[:, 1:]  # drop c0
    cb = mel_to_mcep(logmel_b, n_mfc)[:, 1:]

    if align == "dtw":
        path_a, path_b = _dtw_path(ca, cb)
        ca, cb = ca[path_a], cb[path_b]
    else:
        t = min(len(ca), len(cb))
        ca, cb = ca[:t], cb[:t]

    dists = np.sqrt(np.sum((ca - cb) ** 2, axis=-1))
    return float(MCD_CONST * np.mean(dists))


def _dtw_path(a: np.ndarray, b: np.ndarray):
    """Euclidean DTW alignment path between (Ta, D) and (Tb, D)."""
    ta, tb = len(a), len(b)
    dist = np.sqrt(
        np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    )  # (Ta, Tb)
    cost = np.full((ta + 1, tb + 1), np.inf)
    cost[0, 0] = 0.0
    for i in range(1, ta + 1):
        for j in range(1, tb + 1):
            cost[i, j] = dist[i - 1, j - 1] + min(
                cost[i - 1, j], cost[i, j - 1], cost[i - 1, j - 1]
            )
    # backtrack
    i, j = ta, tb
    pa, pb = [], []
    while i > 0 and j > 0:
        pa.append(i - 1)
        pb.append(j - 1)
        step = int(np.argmin([cost[i - 1, j - 1], cost[i - 1, j], cost[i, j - 1]]))
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.array(pa[::-1]), np.array(pb[::-1])
