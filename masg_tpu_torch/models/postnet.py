"""Mel PostNet: 5x Conv1d(512, k=5) + BatchNorm + tanh residual refiner
(port of masg_tpu/models/postnet.py).

Reference: transformer/Layers.py:67-137, under its parameter names
(`convolutions.i.0.conv`, `convolutions.i.1`). The residual add is done by
the caller. Dropout 0.5 follows every conv output, the last one included
(Layers.py:129-137); it is active in train mode only.

On a `model_axis` (`parallel.tensor.ModelAxis`) that divides the 512
channels, convs 0-3 are column parallel (masg_tpu's `postnet.*conv_[0-3]`
rule): each keeps this rank's output channels, its bias and its
BatchNorm's; the tanh output is gathered back to all channels before the
dropout and the next conv. Conv 4 stays whole. The dropout thus draws the
one-device mask on the whole activation, the same on every model rank (a
mask follows the tensor's memory layout, so the gather keeps the conv's).
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
        """`mesh` (`parallel.mesh.DataMesh`): train-mode statistics over the
        global batch of its data group (this rank's channels are the same
        on every rank of that group)."""
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
                 kernel_size: int = 5, n_convolutions: int = 5, model_axis=None):
        super().__init__()
        self.split = model_axis is not None and model_axis.splits(embedding_dim)
        self.axis = model_axis if self.split else None
        last = n_convolutions - 1
        chans = [n_mel_channels] + [embedding_dim] * last + [n_mel_channels]
        outs = [c // model_axis.size if self.split and i < last else c
                for i, c in enumerate(chans[1:])]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(chans[i], outs[i], kernel_size),
                          TorchBatchNorm(outs[i], eps=1e-5))
            for i in range(n_convolutions))
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """x: (B, T, n_mels) -> (B, T, n_mels); `mesh`: see TorchBatchNorm."""
        last = len(self.convolutions) - 1
        for i, (conv, bn) in enumerate(self.convolutions):
            split = self.axis is not None and i != last
            if split:
                x = self.axis.copy(x)
            x = bn(conv(x.transpose(1, 2)).transpose(1, 2), mesh)
            if i != last:
                x = torch.tanh(x)
            if split:  # gathered in the conv's (B, C, T) layout, where dropout draws
                x = self.axis.gather(x.transpose(1, 2), dim=1).transpose(1, 2)
            x = self.dropout(x)
        return x

    def sharded_params(self):
        """{state-dict key: split dimension} of the tensors this rank holds a
        shard of: convs 0-3 and the BatchNorms after them, by channel."""
        if not self.split:
            return {}
        return {f"convolutions.{i}.{key}": 0 for i in range(len(self.convolutions) - 1)
                for key in ("0.conv.weight", "0.conv.bias", "1.weight", "1.bias",
                            "1.running_mean", "1.running_var")}
