"""HiFi-GAN discriminators, multi-period and multi-scale, for vocoder training
(port of masg_tpu/models/hifigan_disc.py).

The structure and parameter names are upstream jik876/hifi-gan's
(models.py: DiscriminatorP/S, MultiPeriodDiscriminator,
MultiScaleDiscriminator): `discriminators.{i}.convs.{j}`,
`discriminators.{i}.conv_post`, and the MSD's `meanpools`. The modules hold
plain weights, as masg_tpu's do; the trainer puts weight norm on every conv
and spectral norm on the MSD's full-rate scale (`train/vocoder.py`), after
which upstream `do_*` discriminator state dicts load
(`train.vocoder.load_upstream_discriminators`).

The tensors are torch's layout: audio (B, T), a period discriminator's maps
(B, C, T/p, p), a scale discriminator's (B, C, T').
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1

# channel progression of DiscriminatorP's (5, 1)-kernel stack
PERIOD_CHANNELS = (32, 128, 512, 1024)
# (out_ch, kernel, stride, groups) of DiscriminatorS's conv stack
SCALE_LAYERS = (
    (128, 15, 1, 1),
    (128, 41, 2, 4),
    (256, 41, 2, 16),
    (512, 41, 4, 16),
    (1024, 41, 4, 16),
    (1024, 41, 1, 16),
    (1024, 5, 1, 1),
)
# the MSD scale whose convs take spectral norm instead of weight norm
SPECTRAL_NORM_SCALE = 0

Logits = List[torch.Tensor]
FMaps = List[List[torch.Tensor]]


class PeriodDiscriminator(nn.Module):
    """Upstream DiscriminatorP: reflect-pad T to a multiple of the period,
    view the audio as (B, 1, T/p, p) and run a (5, 1)-kernel Conv2d stack."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = PERIOD_CHANNELS):
        super().__init__()
        self.period = period
        k = kernel_size
        ins = [1] + list(channels)
        outs = list(channels) + [channels[-1]]
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, (k, 1), (stride if j < len(channels) else 1, 1),
                      padding=((k - 1) // 2 if j < len(channels) else 2, 0))
            for j, (i, o) in enumerate(zip(ins, outs)))
        self.conv_post = nn.Conv2d(outs[-1], 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B, T) audio -> (flattened logits (B, N), feature maps)."""
        b, t = x.shape
        if t % self.period:
            x = F.pad(x[:, None], (0, self.period - t % self.period), mode="reflect")[:, 0]
            t = x.shape[1]
        x = x.view(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class ScaleDiscriminator(nn.Module):
    """Upstream DiscriminatorS: a 1D conv stack with large grouped kernels."""

    def __init__(self, layers: Sequence[Tuple[int, int, int, int]] = SCALE_LAYERS):
        super().__init__()
        convs, in_ch = [], 1
        for out_ch, k, stride, groups in layers:
            convs.append(nn.Conv1d(in_ch, out_ch, k, stride, groups=groups,
                                   padding=(k - 1) // 2))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv1d(in_ch, 1, 3, 1, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B, T) audio -> (flattened logits, feature maps)."""
        x = x[:, None]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channels: Sequence[int] = PERIOD_CHANNELS):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList(PeriodDiscriminator(p, channels=channels)
                                            for p in self.periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor
                ) -> Tuple[Logits, Logits, FMaps, FMaps]:
        """(B, T) real + generated audio -> (r_logits, g_logits, r_fmaps, g_fmaps)."""
        rs, gs, fr, fg = [], [], [], []
        for d in self.discriminators:
            r, fmap_r = d(y)
            g, fmap_g = d(y_hat)
            rs.append(r), gs.append(g), fr.append(fmap_r), fg.append(fmap_g)
        return rs, gs, fr, fg


class MultiScaleDiscriminator(nn.Module):
    """Scale discriminators at rates 1x, 1/2x, 1/4x; the lower rates are
    `AvgPool1d(4, 2, padding=2)` (count_include_pad, as masg_tpu). Each scale
    sees y, then y_hat: with spectral norm on scale 0 in train mode, that is
    one power iteration per pass, upstream's cadence."""

    def __init__(self, n_scales: int = 3,
                 layers: Sequence[Tuple[int, int, int, int]] = SCALE_LAYERS):
        super().__init__()
        self.discriminators = nn.ModuleList(ScaleDiscriminator(layers)
                                            for _ in range(n_scales))
        self.meanpools = nn.ModuleList(nn.AvgPool1d(4, 2, padding=2)
                                       for _ in range(n_scales - 1))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor
                ) -> Tuple[Logits, Logits, FMaps, FMaps]:
        rs, gs, fr, fg = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i:
                y = self.meanpools[i - 1](y[:, None])[:, 0]
                y_hat = self.meanpools[i - 1](y_hat[:, None])[:, 0]
            r, fmap_r = d(y)
            g, fmap_g = d(y_hat)
            rs.append(r), gs.append(g), fr.append(fmap_r), fg.append(fmap_g)
        return rs, gs, fr, fg


def build_discriminators(cfg: dict) -> Tuple[MultiPeriodDiscriminator, MultiScaleDiscriminator]:
    """(MPD, MSD) from a hifigan config dict. The optional keys `mpd_periods`,
    `mpd_channels`, `msd_scales`, `msd_layers` override upstream V1's sizes
    (small discriminators for tests), as in masg_tpu."""
    mpd = MultiPeriodDiscriminator(
        periods=tuple(cfg.get("mpd_periods", (2, 3, 5, 7, 11))),
        channels=tuple(cfg.get("mpd_channels", PERIOD_CHANNELS)))
    msd = MultiScaleDiscriminator(
        n_scales=int(cfg.get("msd_scales", 3)),
        layers=tuple(tuple(l) for l in cfg.get("msd_layers", SCALE_LAYERS)))
    return mpd, msd


def init_random_weights(module: nn.Module, generator: torch.Generator) -> None:
    """masg_tpu's discriminator init from a seeded generator: every conv
    weight uniform in ±1/sqrt(fan_in) (torch's default conv init), biases 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                w = torch.rand(m.weight.shape, generator=generator, dtype=torch.float64)
                m.weight.copy_((2 * w - 1) / math.sqrt(fan_in))
                m.bias.zero_()
