"""FFT encoder / decoder stacks (port of masg_tpu/models/encoder.py).

Reference: transformer/Models.py:33-183. As in masg_tpu, the positional
encoding is the closed-form sinusoid at the padded length, which equals the
reference's stored table wherever that table reaches. The reference's
`position_enc` table is still registered as a buffer, so its checkpoints
load with `strict=True`; the forward never reads it. A `model_axis`
(`parallel.tensor.ModelAxis`) splits every FFT block's attention and FFN
(`models/layers.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.positional import sinusoid_table
from ..text import N_ACCENT, N_SRC_VOCAB
from .layers import FFTBlock, PaddedEmbedding


def _position_table_buffer(max_seq_len: int, hidden: int) -> torch.Tensor:
    """The reference's (1, max_seq_len + 1, hidden) `position_enc` table."""
    return sinusoid_table(max_seq_len + 1, hidden)[None]


class Encoder(nn.Module):
    """Phoneme + accent embedding + sinusoid PE + N FFT blocks
    (reference Models.py:33-112)."""

    def __init__(self, hidden: int = 256, n_layers: int = 4, n_head: int = 2,
                 d_inner: int = 1024, kernel_size: Tuple[int, int] = (9, 1),
                 dropout: float = 0.2, max_seq_len: int = 1000, use_flash: bool = True,
                 model_axis=None):
        super().__init__()
        self.hidden = hidden
        self.register_buffer("position_enc", _position_table_buffer(max_seq_len, hidden))
        self.src_word_emb = PaddedEmbedding(N_SRC_VOCAB, hidden)
        # accent id 0 shares the PAD row and therefore contributes zeros — a
        # reference quirk (src_accent_emb padding_idx=PAD, Models.py:60-62)
        self.src_accent_emb = PaddedEmbedding(N_ACCENT, hidden)
        self.layer_stack = nn.ModuleList(
            FFTBlock(hidden, n_head, d_inner, kernel_size, dropout, use_flash, model_axis)
            for _ in range(n_layers))

    def forward(self, src_seq: torch.Tensor, pad_mask: torch.Tensor,
                accents: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.src_word_emb(src_seq)
        if accents is not None:
            x = x + self.src_accent_emb(accents)
        x = x + sinusoid_table(src_seq.shape[1], self.hidden, x.dtype, x.device)[None]
        for layer in self.layer_stack:
            x = layer(x, pad_mask, lengths)
        return x


class Decoder(nn.Module):
    """PE + N FFT blocks over frame-level features (reference Models.py:115-183).

    Inputs longer than max_seq_len are truncated (with their masks) only when
    `truncate` is set, which the model does when duration targets are given;
    free-running inference is not truncated.
    """

    def __init__(self, hidden: int = 256, n_layers: int = 6, n_head: int = 2,
                 d_inner: int = 1024, kernel_size: Tuple[int, int] = (9, 1),
                 dropout: float = 0.2, max_seq_len: int = 1000, use_flash: bool = True,
                 model_axis=None):
        super().__init__()
        self.hidden = hidden
        self.max_seq_len = max_seq_len
        self.register_buffer("position_enc", _position_table_buffer(max_seq_len, hidden))
        self.layer_stack = nn.ModuleList(
            FFTBlock(hidden, n_head, d_inner, kernel_size, dropout, use_flash, model_axis)
            for _ in range(n_layers))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, truncate: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = x.shape[1]
        if truncate and t > self.max_seq_len:
            t = self.max_seq_len
            x = x[:, :t]
            pad_mask = pad_mask[:, :t]
            if lengths is not None:
                lengths = lengths.clamp(max=t)
        x = x + sinusoid_table(t, self.hidden, x.dtype, x.device)[None]
        for layer in self.layer_stack:
            x = layer(x, pad_mask, lengths)
        return x, pad_mask
