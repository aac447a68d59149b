# Copied from masg_tpu/audio/f0.py (its numpy DIO + StoneMask) so the port imports nothing of the JAX package.
"""F0 estimation: DIO-style band candidate analysis + StoneMask-style
instantaneous-frequency refinement.

Replaces the reference's pyworld dependency (preprocessor.py:196-201:
`pw.dio` + `pw.stonemask` at frame_period = hop/sr*1000). This is a clean-room
implementation of the published WORLD algorithms (Morise et al.):

  DIO:  for each octave-spaced candidate band, low-pass the signal at the
        band's cutoff and measure four zero-crossing-derived interval series
        (negative/positive crossings, peaks, dips). A band's F0 candidate per
        frame is the mean of the four interval-based estimates; its
        reliability is their deviation. Pick the most reliable candidate per
        frame, then zero out unstable/voiceless frames.
  StoneMask: refine each voiced frame's F0 by the harmonic-weighted mean
        instantaneous frequency of a windowed segment (two passes).

The numpy implementation below is the behavioural reference; the C++
extension (native/f0.cpp, a copy of masg_tpu's, loaded through ctypes by
audio/f0_native.py) implements the same algorithm for the preprocessing path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DEFAULT_F0_FLOOR = 71.0
DEFAULT_F0_CEIL = 800.0


def _lowpass_fft(x: np.ndarray, fs: float, cutoff: float) -> np.ndarray:
    """Zero-phase low-pass via FFT masking with a smooth rolloff."""
    n = len(x)
    nfft = 1 << int(np.ceil(np.log2(n + 1)))
    spec = np.fft.rfft(x, nfft)
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    # raised-cosine rolloff over one octave above the cutoff
    gain = np.ones_like(freqs)
    roll = (freqs > cutoff) & (freqs < 2 * cutoff)
    gain[freqs >= 2 * cutoff] = 0.0
    gain[roll] = 0.5 * (1 + np.cos(np.pi * (freqs[roll] - cutoff) / cutoff))
    return np.fft.irfft(spec * gain, nfft)[:n]


def _interval_series(events: np.ndarray, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """Event sample positions -> (interval centers (s), interval F0s (Hz))."""
    if len(events) < 2:
        return np.empty(0), np.empty(0)
    intervals = np.diff(events) / fs
    centers = (events[:-1] + events[1:]) / 2.0 / fs
    with np.errstate(divide="ignore"):
        f0s = 1.0 / intervals
    return centers, f0s


def _zero_crossings(x: np.ndarray, negative: bool) -> np.ndarray:
    """Sub-sample positions of negative- (or positive-) going zero crossings."""
    if negative:
        hits = np.where((x[:-1] > 0) & (x[1:] <= 0))[0]
    else:
        hits = np.where((x[:-1] < 0) & (x[1:] >= 0))[0]
    if len(hits) == 0:
        return np.empty(0)
    x0 = x[hits].astype(np.float64)
    x1 = x[hits + 1].astype(np.float64)
    frac = np.where(x1 != x0, x0 / (x0 - x1), 0.5)
    return hits + frac


def _band_candidate(
    filtered: np.ndarray,
    fs: float,
    frame_times: np.ndarray,
    boundary_f0: float,
    f0_floor: float,
    f0_ceil: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """One band's (f0 candidate, deviation score) per frame — DIO's
    four-interval analysis (negative/positive crossings, peaks, dips)."""
    series = []
    for sig, negative in ((filtered, True), (filtered, False),
                          (np.diff(filtered), True), (np.diff(filtered), False)):
        ev = _zero_crossings(sig, negative)
        c, f = _interval_series(ev, fs)
        series.append((c, f))

    n_frames = len(frame_times)
    cand = np.zeros(n_frames)
    dev = np.full(n_frames, np.inf)

    interp = []
    for c, f in series:
        if len(c) < 2:
            return cand, dev
        interp.append(np.interp(frame_times, c, f, left=f[0], right=f[-1]))
    stacked = np.stack(interp)  # (4, n_frames)
    mean = stacked.mean(axis=0)
    std = np.sqrt(np.mean((stacked - mean) ** 2, axis=0) + 1e-12)

    ok = (
        (mean > boundary_f0 / 2.0)
        & (mean < boundary_f0 * 2.0)
        & (mean > f0_floor)
        & (mean < f0_ceil)
    )
    cand = np.where(ok, mean, 0.0)
    dev = np.where(ok, std / (mean + 1e-12), np.inf)
    return cand, dev


def dio(
    x: np.ndarray,
    fs: int,
    frame_period: float = 256 / 22050 * 1000,
    f0_floor: float = DEFAULT_F0_FLOOR,
    f0_ceil: float = DEFAULT_F0_CEIL,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate F0 per frame. Returns (f0 (n_frames,), frame times (s)).

    n_frames matches pyworld: floor(len(x)/fs*1000/frame_period) + 1.
    """
    x = np.asarray(x, dtype=np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    t = np.arange(n_frames) * frame_period / 1000.0

    # remove DC
    x = x - x.mean() if len(x) else x

    n_bands = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)) + 1
    boundary_f0s = f0_floor * (2.0 ** ((np.arange(n_bands) + 1) / channels_in_octave))

    best_f0 = np.zeros(n_frames)
    best_dev = np.full(n_frames, np.inf)
    for bf in boundary_f0s:
        filtered = _lowpass_fft(x, fs, bf)
        cand, dev = _band_candidate(filtered, fs, t, bf, f0_floor, f0_ceil)
        better = dev < best_dev
        best_f0 = np.where(better, cand, best_f0)
        best_dev = np.where(better, dev, best_dev)

    # voiced/unvoiced decision: deviation threshold then contour fixing
    f0 = np.where(best_dev < allowed_range, best_f0, 0.0)
    f0 = _fix_contour(f0, allowed_range)
    return f0, t


def _fix_contour(f0: np.ndarray, allowed_range: float) -> np.ndarray:
    """DIO-style contour fixing: voiced frames must agree with a neighbour
    (periodic signals are temporally consistent; noise produces random
    per-frame estimates), then short voiced runs are removed."""
    out = f0.copy()
    n = len(out)
    keep = np.zeros(n, dtype=bool)
    for i in range(n):
        if out[i] <= 0:
            continue
        for j in (i - 1, i + 1):
            if 0 <= j < n and out[j] > 0:
                if abs(out[i] - out[j]) / out[i] < allowed_range:
                    keep[i] = True
                    break
    out = np.where(keep, out, 0.0)

    # remove very short voiced runs (< 3 frames)
    run_start = None
    for i in range(n + 1):
        v = out[i] > 0 if i < n else False
        if v and run_start is None:
            run_start = i
        elif not v and run_start is not None:
            if i - run_start < 3:
                out[run_start:i] = 0.0
            run_start = None
    return out


def stonemask(
    x: np.ndarray,
    f0: np.ndarray,
    t: np.ndarray,
    fs: int,
) -> np.ndarray:
    """Refine F0 via harmonic-weighted mean instantaneous frequency (2 passes)."""
    x = np.asarray(x, dtype=np.float64)
    refined = f0.copy()
    for _ in range(2):
        refined = _refine_pass(x, refined, t, fs)
    return refined


def _refine_pass(x: np.ndarray, f0: np.ndarray, t: np.ndarray, fs: int) -> np.ndarray:
    """Instantaneous frequency via the one-sample phase-difference method:
    IF_k = angle(X(t+1)_k * conj(X(t)_k)) * fs / 2pi — exact for a stationary
    sinusoid even inside window-leakage regions, so harmonic overlap does not
    bias the estimate (unlike a band-power centroid)."""
    out = f0.copy()
    n = len(x)
    for i, (f, ti) in enumerate(zip(f0, t)):
        if f <= 0:
            continue
        half = int(1.5 * fs / f)  # 3-period blackman window
        center = int(ti * fs)
        lo, hi = center - half, center + half
        if lo < 0 or hi + 1 >= n or hi - lo < 8:
            continue
        win = np.blackman(hi - lo)
        nfft = 2 << int(np.ceil(np.log2(hi - lo)))
        x1 = np.fft.rfft(x[lo:hi] * win, nfft)
        x2 = np.fft.rfft(x[lo + 1 : hi + 1] * win, nfft)
        inst = np.angle(x2 * np.conj(x1)) * fs / (2.0 * np.pi)
        freqs = np.arange(len(x1)) * fs / nfft
        power = np.abs(x1) ** 2

        num = 0.0
        den = 0.0
        for h in (1, 2, 3):
            target = f * h
            bw = f * 0.3
            sel = (freqs > target - bw) & (freqs < target + bw)
            if not np.any(sel):
                continue
            w = power[sel]
            valid = inst[sel] > 0
            num += np.sum((inst[sel] / h) * w * valid)
            den += np.sum(w * valid)
        if den > 0:
            cand = num / den
            if abs(cand - f) / f < 0.2:
                out[i] = cand
    return out


def extract_f0(
    x: np.ndarray,
    fs: int,
    frame_period: float = 256 / 22050 * 1000,
    use_native: bool = True,
) -> np.ndarray:
    """DIO + StoneMask: through the C++ extension by default, as masg_tpu's
    `extract_f0`, or in numpy with `use_native=False`. Where masg_tpu falls
    back to numpy when the extension cannot be built or loaded, the port
    raises."""
    if use_native:
        from .f0_native import dio_stonemask_native

        return dio_stonemask_native(x, fs, frame_period)
    f0, t = dio(x, fs, frame_period)
    return stonemask(x, f0, t, fs)
