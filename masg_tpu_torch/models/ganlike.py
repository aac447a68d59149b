"""FastSpeech2 and its GE2E language discriminator as one module, trained
jointly under one optimizer (reference model/ganlike.py:10-45,
train_ganlike.py:83-88).

Its parameters are `model.*` then `discriminator.*` in registration order,
the order of the reference's single ScheduledOptim; a checkpoint keeps the
two halves apart as `{"model", "discriminator", "optimizer"}`
(`core/checkpoint.py`), the layout masg_tpu's `export_torch_ganlike_checkpoint`
writes.
"""

from __future__ import annotations

from torch import nn


class GANLike(nn.Module):
    def __init__(self, model: nn.Module, discriminator: nn.Module):
        super().__init__()
        self.model = model
        self.discriminator = discriminator
