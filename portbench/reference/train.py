"""The FastSpeech2 training step in plain PyTorch: the losses of
`fastspeech2.train_losses`, one backward, the gradient clipped to a global
norm (coefficient max_norm / (norm + 1e-6), at most 1), then one Adam update
(bias-corrected moments, eps added to sqrt(v) / sqrt(1 - b2^t)) at the Noam
rate d_model^-0.5 * min(n^-0.5, n * warmup^-1.5) of update n = 1, 2, ...
It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import fastspeech2


def noam(d_model: int, warmup: int, count: int) -> float:
    """The rate of the update that follows `count` updates."""
    n = float(count) + 1.0
    return float(d_model) ** -0.5 * min(1.0 / math.sqrt(n), n * float(warmup) ** -1.5)


class Trajectory:
    """Follows a run's first steps from the same weights and batches:
    `step(batch, seed)` seeds torch's generators with the run's step seed (so
    dropout draws the same masks) and returns the losses; `grads[0]` holds
    the first step's clipped gradient by name; `params` the weights now."""

    def __init__(self, params: Dict[str, torch.Tensor], model: dict, optim: dict):
        self.model, self.optim = model, optim
        self.names: List[str] = list(params)
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.grads: List[Dict[str, torch.Tensor]] = []

    def step(self, batch: Dict[str, torch.Tensor], seed: int, buffers: Dict[str, torch.Tensor]
             ) -> fastspeech2.Losses:
        torch.manual_seed(seed)
        losses = fastspeech2.train_losses({**buffers, **self.params}, self.model, batch)
        names = self.names
        grads = torch.autograd.grad(losses.total, [self.params[k] for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(self.params[k]) if g is None else g for k, g in zip(names, grads)]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        coef = torch.clamp(self.optim["grad_clip_thresh"] / (norm + 1e-6), max=1.0)
        grads = [g * coef for g in grads]
        self.grads.append(dict(zip(names, grads)))
        b1, b2 = self.optim["betas"]
        lr = noam(self.model["transformer"]["encoder_hidden"], self.optim["warm_up_step"],
                  self.count)
        self.count += 1
        t = self.count
        with torch.no_grad():
            for k, g in zip(names, grads):
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(self.optim["eps"])
                self.params[k].addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** t))
        return losses
