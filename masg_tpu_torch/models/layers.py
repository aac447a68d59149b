"""Shared transformer building blocks (port of masg_tpu/models/layers.py).

Post-LN multi-head self-attention and the conv FFN of the reference's FFT
block (transformer/Layers.py:11-30, SubLayers.py:8-93), under the
reference's torch parameter names, so its checkpoints load with
`strict=True`. Activations are channel-last (B, T, C), as in masg_tpu.

On a model axis (`parallel.tensor.ModelAxis`, masg_tpu's `_PARAM_RULES`)
attention keeps this rank's n_head / M heads of w_qs/w_ks/w_vs (column
parallel, after f) and their rows of fc (row parallel, then g, then fc's
whole bias), and the FFN keeps its d_inner / M channels of w_1 and w_2 the
same way. A layer whose size the axis does not divide stays whole; without
an axis the path is the one-device one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, mha_attention
from ..ops.masks import masked_fill_time


class PaddedEmbedding(nn.Embedding):
    """Embedding whose PAD id (0) gives zeros.

    The output is masked at id 0, not only the table row: tables carried over
    from masg_tpu may hold a nonzero row 0.
    """

    def __init__(self, num_embeddings: int, features: int):
        super().__init__(num_embeddings, features, padding_idx=0)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).masked_fill((ids <= 0)[..., None], 0.0)


class ConvNorm(nn.Module):
    """SAME-padded Conv1d under the reference's `<name>.conv` key, on
    channel-first (B, C, T) input."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, padding=(kernel_size - 1) // 2)

    def forward(self, x_cf: torch.Tensor) -> torch.Tensor:
        return self.conv(x_cf)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention (reference SubLayers.py:8-57).

    With `use_flash` and key lengths given, the core is `flash_attention`
    (kernel K1 on the card); otherwise the plain `mha_attention`. On a
    `model_axis` that divides n_head, `n_head` is this rank's share.
    """

    def __init__(self, n_head: int, d_model: int, dropout: float = 0.1,
                 use_flash: bool = True, model_axis=None):
        super().__init__()
        self.split = model_axis is not None and model_axis.splits(n_head)
        self.axis = model_axis if self.split else None
        self.d_head = d_model // n_head
        self.n_head = n_head // model_axis.size if self.split else n_head
        self.use_flash = use_flash
        self.w_qs = nn.Linear(d_model, self.n_head * self.d_head)
        self.w_ks = nn.Linear(d_model, self.n_head * self.d_head)
        self.w_vs = nn.Linear(d_model, self.n_head * self.d_head)
        self.fc = nn.Linear(self.n_head * self.d_head, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape

        def heads(y):  # (B, T, H*Dh) -> (B, H, T, Dh)
            return y.view(b, t, self.n_head, self.d_head).transpose(1, 2).contiguous()

        xin = x if self.axis is None else self.axis.copy(x)
        q, k, v = heads(self.w_qs(xin)), heads(self.w_ks(xin)), heads(self.w_vs(xin))
        if self.use_flash and lengths is not None:
            out = flash_attention(q, k, v, lengths)
        else:
            out = mha_attention(q, k, v, pad_mask)
        out = out.transpose(1, 2).reshape(b, t, self.n_head * self.d_head)
        if self.axis is None:
            out = self.fc(out)
        else:
            out = self.axis.reduce(F.linear(out, self.fc.weight)) + self.fc.bias
        return self.layer_norm(self.dropout(out) + x)

    def sharded_params(self):
        """{state-dict key: split dimension} of the tensors this rank holds a
        shard of (none unless the axis splits the heads)."""
        if not self.split:
            return {}
        return {**{f"w_{c}s.{t}": 0 for c in "qkv" for t in ("weight", "bias")},
                "fc.weight": 1}


class PositionwiseFeedForward(nn.Module):
    """Conv1d(k0) -> ReLU -> Conv1d(k1), post-LN residual
    (reference SubLayers.py:60-93). On a `model_axis` that divides d_inner,
    this rank's d_inner / M channels."""

    def __init__(self, d_model: int, d_inner: int,
                 kernel_size: Tuple[int, int] = (9, 1), dropout: float = 0.1,
                 model_axis=None):
        super().__init__()
        self.split = model_axis is not None and model_axis.splits(d_inner)
        self.axis = model_axis if self.split else None
        inner = d_inner // model_axis.size if self.split else d_inner
        self.w_1 = nn.Conv1d(d_model, inner, kernel_size[0],
                             padding=(kernel_size[0] - 1) // 2)
        self.w_2 = nn.Conv1d(inner, d_model, kernel_size[1],
                             padding=(kernel_size[1] - 1) // 2)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            h = self.w_2(F.relu(self.w_1(x.transpose(1, 2)))).transpose(1, 2)
        else:  # in the one-device memory layout, (B, C, T): dropout draws its mask in it
            h = F.relu(self.w_1(self.axis.copy(x).transpose(1, 2)))
            h = F.conv1d(h, self.w_2.weight, None, padding=self.w_2.padding)
            h = (self.axis.reduce(h) + self.w_2.bias[:, None]).transpose(1, 2)
        return self.layer_norm(self.dropout(h) + x)

    def sharded_params(self):
        """{state-dict key: split dimension} of the tensors this rank holds a
        shard of (none unless the axis splits d_inner)."""
        return {"w_1.weight": 0, "w_1.bias": 0, "w_2.weight": 1} if self.split else {}


class FFTBlock(nn.Module):
    """Self-attn -> zero pads -> conv-FFN -> zero pads (reference Layers.py:11-30)."""

    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_size: Tuple[int, int] = (9, 1), dropout: float = 0.1,
                 use_flash: bool = True, model_axis=None):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, dropout, use_flash, model_axis)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size, dropout,
                                               model_axis)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = masked_fill_time(self.slf_attn(x, pad_mask, lengths), pad_mask)
        return masked_fill_time(self.pos_ffn(x), pad_mask)
