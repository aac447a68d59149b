"""MelGAN generator (descriptinc/melgan-neurips) for mel -> wav (port of
masg_tpu/models/melgan.py).

The reference loads it with `torch.hub.load("descriptinc/melgan-neurips",
"load_melgan")` (utils/model.py:46-56) and feeds it natural-log mels divided
by ln 10 (:76-78: the descript checkpoints were trained on log10 mels;
`infer/vocoder.py:Vocoder.mel_scale`). torch.hub needs the network, so, as in
masg_tpu, the generator is built here and a local descript checkpoint
converts to it (`convert_descript_state_dict`).

Architecture (descript mel2wav/modules.py; defaults ngf 32, 3 residual
layers, ratios (8, 8, 2, 2)): a reflection-padded 7-tap conv to 16 ngf
channels, then per ratio r [LeakyReLU(0.2) -> ConvTranspose1d(k = 2r,
stride r, padding r // 2 + r % 2, output_padding r % 2) -> residual blocks
of dilation 3^j: shortcut 1x1 conv + (LeakyReLU -> reflection pad d ->
3-tap conv of dilation d -> LeakyReLU -> 1x1 conv)], then LeakyReLU, a
reflection-padded 7-tap conv to 1 channel and tanh. T mel frames give
exactly T * prod(ratios) samples. Weight norm is folded into the weights.

The modules are named after masg_tpu's params (`conv_pre`, `ups.i`,
`res.i.j.{conv1,conv2,shortcut}`, `conv_post`). The layout is channel-last,
mel (B, T, n_mels) -> wav (B, T * prod(ratios)). No kernel of this package
runs here: every layer is a plain PyTorch convolution (cuDNN on the card).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .hifigan import fold_weight_norm

LRELU_SLOPE = 0.2


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection padding of (B, C, T) by `pad` on each side of T, with
    numpy's (and `jnp.pad`'s) rule for a pad at or past T: the reflection
    repeats, so a window shorter than a padding still runs."""
    t = x.shape[-1]
    if pad == 0:
        return x
    if pad < t:
        return F.pad(x, (pad, pad), mode="reflect")
    i = torch.arange(-pad, t + pad, device=x.device)
    if t == 1:
        idx = torch.zeros_like(i)
    else:
        m = i.remainder(2 * (t - 1))
        idx = torch.where(m < t, m, 2 * (t - 1) - m)
    return x.index_select(-1, idx)


class _ResBlock(nn.Module):
    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.conv1 = nn.Conv1d(channels, channels, 3, dilation=dilation)
        self.conv2 = nn.Conv1d(channels, channels, 1)
        self.shortcut = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = reflect_pad(F.leaky_relu(x, LRELU_SLOPE), self.dilation)
        h = self.conv2(F.leaky_relu(self.conv1(h), LRELU_SLOPE))
        return self.shortcut(x) + h


class MelGANGenerator(nn.Module):
    def __init__(self, n_mels: int = 80, ngf: int = 32, n_residual_layers: int = 3,
                 ratios: Sequence[int] = (8, 8, 2, 2)):
        super().__init__()
        self.ngf = ngf
        self.n_residual_layers = n_residual_layers
        self.ratios = tuple(ratios)
        ch = 2 ** len(self.ratios) * ngf
        self.conv_pre = nn.Conv1d(n_mels, ch, 7)
        self.ups = nn.ModuleList()
        self.res = nn.ModuleList()
        for r in self.ratios:
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, 2 * r, stride=r,
                                               padding=r // 2 + r % 2, output_padding=r % 2))
            ch //= 2
            self.res.append(nn.ModuleList(_ResBlock(ch, 3 ** j)
                                          for j in range(n_residual_layers)))
        self.conv_post = nn.Conv1d(ch, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mels), log10-scaled -> wav (B, T * prod(ratios))."""
        x = self.conv_pre(reflect_pad(mel.transpose(1, 2), 3))
        for up, blocks in zip(self.ups, self.res):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            for block in blocks:
                x = block(x)
        x = self.conv_post(reflect_pad(F.leaky_relu(x, LRELU_SLOPE), 3))
        return torch.tanh(x)[:, 0]


def init_random_weights(gen: MelGANGenerator, generator: torch.Generator) -> None:
    """Seeded random weights: normal with std 1/sqrt(fan_in) per conv (fan_in
    = C_in * k, or C_in * k / stride for a transposed conv), the residual
    shortcuts' scaled by 0.8, and zero biases: a random generator's wav of a
    speech-like log-mel stays in the audio range (mean |sample| ~0.1) instead
    of saturating tanh through its 12 residual sums."""
    with torch.no_grad():
        for name, m in gen.named_modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                fan_in = m.in_channels * m.kernel_size[0]
                if isinstance(m, nn.ConvTranspose1d):
                    fan_in /= m.stride[0]
                gain = 0.8 if name.endswith("shortcut") else 1.0
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * (gain / math.sqrt(fan_in)))
                m.bias.zero_()


def convert_descript_state_dict(state_dict: Mapping[str, torch.Tensor],
                                n_residual_layers: int = 3,
                                ratios: Sequence[int] = (8, 8, 2, 2)) -> dict:
    """A descript MelGAN generator state_dict -> this module's state_dict.

    Keys follow descript's `nn.Sequential` (`model.<idx>...`, a `mel2wav.`
    prefix stripped), walked in masg_tpu's order (`convert_torch_state_dict`,
    models/melgan.py:86-127); weight norm (`weight_g`/`weight_v`) is folded,
    a plain `weight` taken as it is; the layouts are torch's on both sides."""
    sd = {k.split("mel2wav.", 1)[-1]: torch.as_tensor(v) for k, v in state_dict.items()}
    out = {}

    def put(name: str, prefix: str) -> None:
        out[f"{name}.weight"] = fold_weight_norm(sd, prefix)
        out[f"{name}.bias"] = sd[prefix + ".bias"]

    put("conv_pre", "model.1")
    idx = 2
    for i in range(len(ratios)):
        idx += 1  # LeakyReLU
        put(f"ups.{i}", f"model.{idx}")
        idx += 1
        for j in range(n_residual_layers):
            put(f"res.{i}.{j}.conv1", f"model.{idx}.block.2")
            put(f"res.{i}.{j}.conv2", f"model.{idx}.block.4")
            put(f"res.{i}.{j}.shortcut", f"model.{idx}.shortcut")
            idx += 1
    idx += 2  # LeakyReLU, ReflectionPad1d
    put("conv_post", f"model.{idx}")
    return out
