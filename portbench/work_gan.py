"""Useful operations of one HiFi-GAN GAN step (`drivers/gan.py`), from the
configuration's widths, at batch B and `segment_size` samples.

A convolution's forward costs 2 x (its input channels per group) x (its
output channels) x (its taps) x (its output positions) x B, padded
positions included; a transposed convolution 2 x C_in x C_out x k x (its
input positions) x B. A backward is counted as the step runs it:
- the discriminators' update: both inputs (y and y_hat detached) through
  every discriminator, then the weight gradient of every conv and the
  input gradient of every conv but each discriminator's first (its input,
  the audio, takes none);
- the generator's update: both inputs through the updated discriminators,
  the input gradients through them on y_hat's side alone (the loss reaches
  the generator's parameters only), then the generator's weight gradients
  and its input gradients but conv_pre's;
- three log-mel spectrograms (the generator's input, the loss mel of y
  and of y_hat) and the backward of y_hat's: a real FFT of n points as
  2.5 n log2 n operations a frame, the magnitude and the mel projection.
The optimizers' elementwise passes, the weight and spectral norms and the
activations are not counted.
"""

from __future__ import annotations

import math
from typing import List, Tuple

Conv = Tuple[int, bool]  # (forward operations, takes the audio as input)


def conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def period_convs(d: dict, period: int, samples: int, b: int) -> List[Conv]:
    """One period discriminator over b rows of `samples` samples."""
    rows = -(-samples // period)
    k, s, chans = d["period_kernel_size"], d["period_stride"], d["period_channels"]
    out, c_in = [], 1
    for j, c in enumerate(list(chans) + [chans[-1]]):
        last = j == len(chans)
        rows = conv_out(rows, k, 1 if last else s, 2 if last else (k - 1) // 2)
        out.append((2 * c_in * c * k * rows * period * b, j == 0))
        c_in = c
    return out + [(2 * c_in * 1 * 3 * rows * period * b, False)]


def scale_convs(d: dict, samples: int, b: int) -> List[Conv]:
    """One scale discriminator over b rows of `samples` samples."""
    out, c_in, t = [], 1, samples
    for j, (c, k, s, groups) in enumerate(d["scale_layers"]):
        t = conv_out(t, k, s, (k - 1) // 2)
        out.append((2 * (c_in // groups) * c * k * t * b, j == 0))
        c_in = c
    return out + [(2 * c_in * 3 * t * b, False)]


def discriminator_convs(d: dict, samples: int, b: int) -> List[Conv]:
    """Every conv of the MPD and the MSD over one input of b rows."""
    out = [c for p in d["periods"] for c in period_convs(d, p, samples, b)]
    k, s, pad = d["scale_pool"]
    t = samples
    for i in range(d["scales"]):
        if i:
            t = conv_out(t, k, s, pad)
        out += scale_convs(d, t, b)
    return out


def generator_convs(h: dict, frames: int, b: int) -> List[Conv]:
    """Every conv of the generator at `frames` mel frames a row; the flag
    marks conv_pre, whose input (the mel) takes no gradient."""
    ch, n_mels = h["upsample_initial_channel"], h["num_mels"]
    out = [(2 * n_mels * ch * 7 * frames * b, True)]
    t = frames
    taps = sum(2 * len(dil) * k for k, dil in zip(h["resblock_kernel_sizes"],
                                                  h["resblock_dilation_sizes"]))
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        c_in, c = ch // 2 ** i, ch // 2 ** (i + 1)
        out.append((2 * c_in * c * k * t * b, False))
        t *= u
        out.append((2 * c * c * taps * t * b, False))  # the MRF stage's convs
    return out + [(2 * (ch // 2 ** len(h["upsample_rates"])) * 7 * t * b, False)]


def mel_flops(h: dict, samples: int, b: int) -> int:
    """One log-mel spectrogram of b rows (upstream's frames: a reflect pad of
    (n_fft - hop) / 2 each side, no centring)."""
    n_fft, hop = h["n_fft"], h["hop_size"]
    frames = (samples + 2 * ((n_fft - hop) // 2) - n_fft) // hop + 1
    bins = n_fft // 2 + 1
    per_frame = 2.5 * n_fft * math.log2(n_fft) + n_fft + 4 * bins + 2 * bins * h["num_mels"]
    return int(per_frame * frames * b)


def step_parts(config: dict, b: int) -> dict:
    """The step's operations by part."""
    h, d = config["hifigan"], config["discriminators"]
    seg = h["segment_size"]
    frames = seg // h["hop_size"]
    disc = discriminator_convs(d, seg, b)
    fwd_d = sum(f for f, _ in disc)
    dgrad_d = sum(f for f, first in disc if not first)
    gen = generator_convs(h, frames, b)
    fwd_g = sum(f for f, _ in gen)
    mel = mel_flops(h, seg, b)
    return {
        "generator_forward": fwd_g,
        "disc_update": 2 * fwd_d + 2 * (fwd_d + dgrad_d),
        "gen_update_discriminators": 2 * fwd_d + fwd_d,
        "generator_backward": fwd_g + sum(f for f, first in gen if not first),
        "mels": 4 * mel,
    }


def step_flops(config: dict, b: int) -> int:
    return int(sum(step_parts(config, b).values()))

