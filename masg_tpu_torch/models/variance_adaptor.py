"""Variance adaptor: duration/pitch/energy predictors + length regulation
(port of masg_tpu/models/variance_adaptor.py).

Reference: model/modules.py:17-296, under its torch parameter names. The
pitch and energy bin edges are registered as the reference's `pitch_bins` /
`energy_bins` buffers and are kept in float32 whatever the compute dtype.

Deliberately preserved reference quirk: the energy path receives `p_control`,
not `e_control` (modules.py:123-126,144-148).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.length_regulator import regulate_lengths
from ..ops.masks import pad_mask_from_lengths
from ..utils import profiling
from .layers import ConvNorm


def make_bins(vmin: float, vmax: float, n_bins: int, quantization: str) -> np.ndarray:
    """(n_bins - 1,) bucket boundaries (reference modules.py:48-71)."""
    if quantization == "log":
        return np.exp(np.linspace(np.log(vmin), np.log(vmax), n_bins - 1)).astype(np.float32)
    return np.linspace(vmin, vmax, n_bins - 1).astype(np.float32)


class _ConvLayer(nn.Module):
    """The reference's `conv_layer` Sequential: only its parameterised members."""

    def __init__(self, hidden: int, filter_size: int, kernel_size: int):
        super().__init__()
        self.conv1d_1 = ConvNorm(hidden, filter_size, kernel_size)
        self.layer_norm_1 = nn.LayerNorm(filter_size, eps=1e-5)
        self.conv1d_2 = ConvNorm(filter_size, filter_size, kernel_size)
        self.layer_norm_2 = nn.LayerNorm(filter_size, eps=1e-5)


class VariancePredictor(nn.Module):
    """Conv(k)->ReLU->LN->Dropout x2 -> Linear -> scalar per position
    (reference modules.py:197-250)."""

    def __init__(self, hidden: int = 256, filter_size: int = 256, kernel_size: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.conv_layer = _ConvLayer(hidden, filter_size, kernel_size)
        self.dropout = nn.Dropout(dropout)
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.conv_layer
        h = F.relu(c.conv1d_1(x.transpose(1, 2))).transpose(1, 2)
        h = self.dropout(c.layer_norm_1(h))
        h = F.relu(c.conv1d_2(h.transpose(1, 2))).transpose(1, 2)
        h = self.dropout(c.layer_norm_2(h))
        out = self.linear_layer(h)[..., 0]
        if pad_mask is not None:
            out = out.masked_fill(pad_mask, 0.0)
        return out


class VarianceAdaptorOutput(NamedTuple):
    x: torch.Tensor  # (B, T_mel, H) frame-level features
    pitch_prediction: torch.Tensor
    energy_prediction: torch.Tensor
    log_duration_prediction: torch.Tensor
    duration_rounded: torch.Tensor
    mel_len: torch.Tensor  # (B,)
    mel_pad_mask: torch.Tensor  # (B, T_mel)


class VarianceAdaptor(nn.Module):
    """Reference modules.py:17-158 with static-shape length regulation.

    `max_mel_len` is the frame capacity: the batch's padded mel length with
    targets, or the inference cap.
    """

    def __init__(self, pitch_bins: Sequence[float], energy_bins: Sequence[float],
                 n_bins: int = 256, hidden: int = 256, filter_size: int = 256,
                 kernel_size: int = 3, dropout: float = 0.5,
                 pitch_feature_level: str = "phoneme_level",
                 energy_feature_level: str = "phoneme_level"):
        super().__init__()
        self.pitch_feature_level = pitch_feature_level
        self.energy_feature_level = energy_feature_level
        self.register_buffer("pitch_bins", torch.tensor(np.asarray(pitch_bins, np.float32)))
        self.register_buffer("energy_bins", torch.tensor(np.asarray(energy_bins, np.float32)))
        self.duration_predictor = VariancePredictor(hidden, filter_size, kernel_size, dropout)
        self.pitch_predictor = VariancePredictor(hidden, filter_size, kernel_size, dropout)
        self.energy_predictor = VariancePredictor(hidden, filter_size, kernel_size, dropout)
        self.pitch_embedding = nn.Embedding(n_bins, hidden)
        self.energy_embedding = nn.Embedding(n_bins, hidden)

    def _apply(self, fn, recurse=True):
        # bin edges keep their float32 values under .to(dtype): bucketizing
        # against bf16-rounded edges would move values across bins
        keep = {n: getattr(self, n) for n in ("pitch_bins", "energy_bins")}
        super()._apply(fn, recurse)
        for n, v in keep.items():
            setattr(self, n, v.to(getattr(self, n).device))
        return self

    @staticmethod
    def _embed(table: nn.Embedding, bins: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        # torch.bucketize(right=False) == searchsorted(side="left")
        return table(torch.bucketize(values.float(), bins, right=False))

    def _branch(self, predictor, table, bins, target, mask, control, h):
        pred = predictor(h, mask)
        if target is not None:
            return pred, self._embed(table, bins, target)
        pred = pred * control
        return pred, self._embed(table, bins, pred)

    def forward(self, x: torch.Tensor, src_pad_mask: torch.Tensor, max_mel_len: int,
                mel_pad_mask: Optional[torch.Tensor] = None,
                pitch_target: Optional[torch.Tensor] = None,
                energy_target: Optional[torch.Tensor] = None,
                duration_target: Optional[torch.Tensor] = None,
                p_control: float = 1.0, e_control: float = 1.0,
                d_control: float = 1.0) -> VarianceAdaptorOutput:
        del e_control  # reference quirk: energy uses p_control (modules.py:123-126)
        log_d_pred = self.duration_predictor(x, src_pad_mask)

        pitch_pred = energy_pred = None
        if self.pitch_feature_level == "phoneme_level":
            pitch_pred, emb = self._branch(self.pitch_predictor, self.pitch_embedding,
                                           self.pitch_bins, pitch_target, src_pad_mask,
                                           p_control, x)
            x = x + emb
        if self.energy_feature_level == "phoneme_level":
            energy_pred, emb = self._branch(self.energy_predictor, self.energy_embedding,
                                             self.energy_bins, energy_target,
                                             src_pad_mask, p_control, x)
            x = x + emb

        if duration_target is not None:
            duration_rounded = duration_target
            with profiling.span("fs2.length_regulator", stream_time=x):
                x, mel_len = regulate_lengths(x, duration_target, max_mel_len)
            if mel_pad_mask is None:
                mel_pad_mask = pad_mask_from_lengths(mel_len, max_mel_len)
        else:
            # torch.round rounds half to even, as jnp.round does
            duration_rounded = torch.clamp(
                torch.round(torch.exp(log_d_pred) - 1.0) * d_control, min=0)
            # padded phonemes predict 0 after mask-fill -> exp(0)-1 = 0: safe
            with profiling.span("fs2.length_regulator", stream_time=x):
                x, mel_len = regulate_lengths(x, duration_rounded, max_mel_len)
            mel_pad_mask = pad_mask_from_lengths(mel_len, max_mel_len)

        if self.pitch_feature_level == "frame_level":
            pitch_pred, emb = self._branch(self.pitch_predictor, self.pitch_embedding,
                                           self.pitch_bins, pitch_target, mel_pad_mask,
                                           p_control, x)
            x = x + emb
        if self.energy_feature_level == "frame_level":
            energy_pred, emb = self._branch(self.energy_predictor, self.energy_embedding,
                                            self.energy_bins, energy_target, mel_pad_mask,
                                            p_control, x)
            x = x + emb

        return VarianceAdaptorOutput(x, pitch_pred, energy_pred, log_d_pred,
                                     duration_rounded, mel_len, mel_pad_mask)
