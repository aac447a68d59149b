"""Mel PostNet: 5x Conv1d(512, k=5) + BatchNorm + tanh residual refiner
(port of masg_tpu/models/postnet.py).

Reference: transformer/Layers.py:67-137, under its parameter names
(`convolutions.i.0.conv`, `convolutions.i.1`). The residual add is done by
the caller. Dropout 0.5 follows every conv output, the last one included
(Layers.py:129-137); it is active in train mode only.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConvNorm


class TorchBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d over the channel-last (B, T, C) layout, with masg_tpu's
    `TorchBatchNorm` arithmetic.

    Train mode normalises with the biased batch variance, its statistics
    taken in `promote(x.dtype, float32)`, and folds the UNBIASED variance
    (x n/(n-1)) into the running average with torch's momentum (0.1 == flax's
    0.9). Eval mode normalises with the running statistics. Either way
    (x - mean) / sqrt(var + eps) * weight + bias runs with the statistics cast
    to the activation dtype. The running statistics are float32 (float64 in
    a float64 model). Keeps nn.BatchNorm1d's state_dict keys.
    """

    def _apply(self, fn, recurse=True):
        # running statistics stay float32 under .to(dtype), as masg_tpu keeps its
        # batch_stats collection in float32; under a float64 model they follow it,
        # as masg_tpu's do under x64
        keep = {n: getattr(self, n) for n in ("running_mean", "running_var")}
        super()._apply(fn, recurse)
        for n, v in keep.items():
            new = getattr(self, n)
            dtype = torch.float64 if new.dtype == torch.float64 else torch.float32
            setattr(self, n, v.to(new.device, dtype))
        return self

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            if mesh is None or mesh.parts == 1:
                mean = xf.mean(dim=(0, 1))
                var = (xf - mean).square().mean(dim=(0, 1))  # biased: normalisation
                n = x.shape[0] * x.shape[1]
            else:
                n = x.shape[0] * x.shape[1] * mesh.parts
                mean = mesh.sum(xf.sum(dim=(0, 1))) / n
                var = mesh.sum((xf - mean).square().sum(dim=(0, 1))) / n
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean.to(self.running_mean.dtype))
                self.running_var.mul_(1 - m).add_(
                    m * (var * (n / max(n - 1, 1))).to(self.running_var.dtype))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        std = torch.sqrt(var + self.eps).to(x.dtype)
        return (x - mean.to(x.dtype)) / std * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class PostNet(nn.Module):
    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5):
        super().__init__()
        chans = [n_mel_channels] + [embedding_dim] * (n_convolutions - 1) + [n_mel_channels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(chans[i], chans[i + 1], kernel_size),
                          TorchBatchNorm(chans[i + 1], eps=1e-5))
            for i in range(n_convolutions))
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """x: (B, T, n_mels) -> (B, T, n_mels); `mesh`: see TorchBatchNorm."""
        last = len(self.convolutions) - 1
        for i, (conv, bn) in enumerate(self.convolutions):
            x = bn(conv(x.transpose(1, 2)).transpose(1, 2), mesh)
            if i != last:
                x = torch.tanh(x)
            x = self.dropout(x)
        return x
