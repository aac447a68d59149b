"""HiFi-GAN generator (V1) for mel -> waveform synthesis (port of
masg_tpu/models/hifigan.py).

Reference: hifigan/models.py:20-174 + hifigan/config.json (universal V1:
upsample rates [8,8,2,2], kernels [16,16,4,4], 512 initial channels, MRF
resblock kernels [3,7,11] with dilations (1,3,5)). Parameter names are the
upstream torch names (`conv_pre`, `ups.i`, `resblocks.{i*n+j}.convs{1,2}.c`,
`conv_post`) with weight norm folded, as masg_tpu's `convert_torch_state_dict`
reads them. The public layout is channel-last: mel (B, T, n_mels).

With `fused_mrf` (the default), each MRF stage whose width is at most 64 and
whose resblock kernels are all odd runs as one `fused_mrf_stage` call, the
condition masg_tpu uses (masg_tpu/models/hifigan.py:227-228). On the card
every such stage launches kernel K4: C = 64, 32, 16 and 8 at their own
width (V1's last two stages; all four of V2's and of any generator of 128
initial channels), C = 1, 2 and 4 at 8 on zero-padded channels; a width that
does not divide 128 raises, as masg_tpu's kernel takes only those. On the CPU
the stage runs the plain version. masg_tpu's `time_packing` is an
exact relayout for the TPU's matrix unit and has no counterpart here: the
unfused path below is its plain equivalent.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_mrf import (LRELU_SLOPE, PackedStage, fused_mrf_stage, get_padding,
                             pack_stage_weights)
from ..utils import profiling


class ResBlock(nn.Module):
    """MRF residual block (reference hifigan/models.py:20-109, ResBlock1)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in self.dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in self.dilations)

    def forward(self, x_cf: torch.Tensor) -> torch.Tensor:
        """Channel-first (B, C, T)."""
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x_cf, LRELU_SLOPE)), LRELU_SLOPE))
            x_cf = xt + x_cf
        return x_cf

    def kernel_params(self) -> dict:
        """This block's weights in masg_tpu's layout, as `fused_mrf_stage`
        takes them: `convs{1,2}_{i}_kernel` (k, C_in, C_out) and `_bias` (C,)."""
        out = {}
        for name, convs in (("convs1", self.convs1), ("convs2", self.convs2)):
            for i, conv in enumerate(convs):
                out[f"{name}_{i}_kernel"] = conv.weight.permute(2, 1, 0)
                out[f"{name}_{i}_bias"] = conv.bias
        return out


class HiFiGANGenerator(nn.Module):
    """Reference hifigan/models.py:112-174."""

    def __init__(self, n_mels: int = 80,
                 upsample_rates: Tuple[int, ...] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3,
                 fused_mrf: bool = True):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.fused_mrf = fused_mrf
        ch = upsample_initial_channel
        self.conv_pre = nn.Conv1d(n_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            out_ch = ch // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch // (2 ** i), out_ch, k, u,
                                               padding=(k - u) // 2))
            for rk, rd in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(out_ch, rk, rd))
        self.conv_post = nn.Conv1d(ch // (2 ** len(upsample_rates)), 1, 7, padding=3)
        # (stage, dtype, device) -> (parameter key, pinned tensors, PackedStage)
        self._mrf_packed: dict = {}

    def _stage_is_fused(self, channels: int) -> bool:
        return (self.fused_mrf and channels <= 64
                and all(k % 2 == 1 for k in self.resblock_kernel_sizes))

    def packed_mrf(self, stage: int, dtype: torch.dtype, device) -> PackedStage:
        """Stage `stage`'s MRF weights in K4's layout for `dtype` on `device`.

        Packed once and reused until a parameter of the stage changes: a
        `load_state_dict` or an optimizer step bumps a tensor's version, and
        `.to` gives it new storage. The cache keeps the packed tensors'
        sources alive, so a freed storage cannot come back at the same
        address with the same version."""
        n_res = len(self.resblock_kernel_sizes)
        blocks = self.resblocks[stage * n_res:(stage + 1) * n_res]
        params = [p for b in blocks for p in b.parameters()]
        key = tuple((p.data_ptr(), p._version) for p in params)
        slot = (stage, dtype, torch.device(device))
        hit = self._mrf_packed.get(slot)
        if hit is None or hit[0] != key:
            packed = pack_stage_weights([b.kernel_params() for b in blocks],
                                        self.resblock_kernel_sizes,
                                        len(self.resblock_dilation_sizes[0]), dtype, device)
            hit = self._mrf_packed[slot] = (key, [p.detach() for p in params], packed)
        return hit[2]

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, T, n_mels) channel-last -> wav (B, T * prod(rates))."""
        n_res = len(self.resblock_kernel_sizes)
        plain = 0
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * n_res:(i + 1) * n_res]
            if self._stage_is_fused(x.shape[1]):
                packed = self.packed_mrf(i, x.dtype, x.device) if x.is_cuda else None
                x = fused_mrf_stage(x.transpose(1, 2).contiguous(),
                                    [b.kernel_params() for b in blocks],
                                    self.resblock_kernel_sizes,
                                    self.resblock_dilation_sizes, packed).transpose(1, 2)
                continue
            plain += 1
            xs = None
            for block in blocks:
                r = block(x)
                xs = r if xs is None else xs + r
            x = xs / n_res
        if plain:
            profiling.count("hifigan.plain_mrf_stages", plain)
        # the final activation uses leaky_relu's default slope 0.01, not 0.1
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x)[:, 0, :]


def init_random_weights(gen: HiFiGANGenerator, generator: torch.Generator) -> None:
    """Fill `gen` with seeded random weights: normal with std 1/sqrt(fan_in)
    per conv (fan_in = C_in * k, or C_in * k / stride for a transposed conv)
    and zero biases, so a random vocoder's wav keeps an audio-range level
    through the 4 upsampling stages instead of fading to a few LSB."""
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                if isinstance(m, nn.ConvTranspose1d):
                    fan_in = m.in_channels * m.kernel_size[0] / m.stride[0]
                else:
                    fan_in = m.in_channels * m.kernel_size[0]
                w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
                m.weight.copy_(w)
                m.bias.zero_()


def fold_weight_norm(state_dict: dict, prefix: str) -> torch.Tensor:
    """`prefix.weight`, or g * v / ||v|| from `prefix.weight_g`/`weight_v`
    (norm over all but dim 0, torch weight_norm's default)."""
    if prefix + ".weight" in state_dict:
        return state_dict[prefix + ".weight"]
    v = state_dict[prefix + ".weight_v"].float()
    g = state_dict[prefix + ".weight_g"].float()
    return g * v / v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
