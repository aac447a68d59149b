"""Alternative LSTM language classifier over mels (port of
masg_tpu/models/discriminator.py).

Reference: model/discriminator.py:7-29 — LSTM(n_mels -> hidden) + Linear +
softmax over languages. Exported for parity; the trainers use the GE2E
`SpeechEmbedder` instead, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn


class LangDiscriminator(nn.Module):
    def __init__(self, n_mels: int = 80, hidden: int = 256, n_languages: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(n_mels, hidden, batch_first=True)
        self.linear = nn.Linear(hidden, n_languages)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) -> (B, n_languages) softmax probabilities."""
        x, _ = self.lstm(mels.to(self.linear.weight.dtype))
        return torch.softmax(self.linear(x[:, -1]), dim=-1)
