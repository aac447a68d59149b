"""The HiFi-GAN generator (jik876/hifi-gan `models.py`, ResBlock1) in plain
PyTorch, as functions over a dict of tensors under the upstream names with
weight norm folded. It imports nothing of the program under test.

mel (B, T, n_mels) -> conv_pre (k 7) -> per stage: leaky ReLU 0.1, transposed
conv (kernel k, stride u, padding (k - u) / 2), then the mean of one residual
block per kernel size, each block a chain of (leaky ReLU, dilated conv,
leaky ReLU, conv) units with a residual add -> leaky ReLU 0.01 -> conv_post
(k 7) -> tanh -> (B, T * prod(u)).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

P = Dict[str, torch.Tensor]
SLOPE = 0.1


def spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor; kinds `conv`, `conv_t/<stride>`
    and `bias`."""
    ch = cfg["upsample_initial_channel"]
    ks, ds = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
    out = [("conv_pre.weight", (ch, cfg["num_mels"], 7), "conv"), ("conv_pre.bias", (ch,), "bias")]
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        out += [(f"ups.{i}.weight", (cin, cout, k), f"conv_t/{u}"), (f"ups.{i}.bias", (cout,), "bias")]
        for j, (rk, rd) in enumerate(zip(ks, ds)):
            for name in ("convs1", "convs2"):
                for c in range(len(rd)):
                    pre = f"resblocks.{i * len(ks) + j}.{name}.{c}"
                    out += [(f"{pre}.weight", (cout, cout, rk), "conv"), (f"{pre}.bias", (cout,), "bias")]
    c_last = ch // 2 ** len(cfg["upsample_rates"])
    out += [("conv_post.weight", (1, c_last, 7), "conv"), ("conv_post.bias", (1,), "bias")]
    return out


def _pad(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def generate(p: P, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) -> float wav (B, T * prod(upsample_rates))."""
    ks, ds = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
    x = F.conv1d(mel.transpose(1, 2), p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(F.leaky_relu(x, SLOPE), p[f"ups.{i}.weight"], p[f"ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        acc = None
        for j, (rk, rd) in enumerate(zip(ks, ds)):
            h = x
            for c, dil in enumerate(rd):
                pre = f"resblocks.{i * len(ks) + j}"
                t = F.conv1d(F.leaky_relu(h, SLOPE), p[f"{pre}.convs1.{c}.weight"],
                             p[f"{pre}.convs1.{c}.bias"], padding=_pad(rk, dil), dilation=dil)
                t = F.conv1d(F.leaky_relu(t, SLOPE), p[f"{pre}.convs2.{c}.weight"],
                             p[f"{pre}.convs2.{c}.bias"], padding=_pad(rk))
                h = t + h
            acc = h if acc is None else acc + h
        x = acc / len(ks)
    x = F.conv1d(F.leaky_relu(x), p["conv_post.weight"], p["conv_post.bias"], padding=3)
    return torch.tanh(x)[:, 0, :]


def to_int16(wav: np.ndarray, max_wav_value: float = 32768.0) -> np.ndarray:
    """Float wav -> int16 samples, clipped before the cast (which truncates)."""
    return np.clip(wav * max_wav_value, -32768, 32767).astype(np.int16)
