"""Checkpoint manager (port of masg_tpu/core/checkpoint.py).

The reference's semantics (train.py:271-285, utils/model.py:11-34):
- every save_step, save the model (parameters + BatchNorm statistics), the
  optimizer and the schedule, keyed by step;
- `--restore_step N` restores all of them and the step counter;
- `--checkpoint path` warm-starts the MODEL only, from another run.

One `torch.save` file per step, `<ckpt_dir>/<step>.pth.tar`, with the
FastSpeech2 weights under "model" as the reference's checkpoints hold them,
so `infer.synthesis.load_model` reads it. `max_to_keep` keeps the newest N.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from ..train.state import TrainState

_NAME = re.compile(r"^(\d+)\.pth\.tar$")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{step}.pth.tar")

    def save(self, step: int, state: TrainState) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": step,
            "micro_step": state.micro_step,
            # the accumulated gradient of an update still in progress
            "acc_grads": ([p.grad for p in state.model.parameters()]
                          if state.micro_step else None),
        }
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))  # a reader sees a whole file or none
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))

    def _load(self, step: int) -> dict:
        if step not in self.all_steps():
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.ckpt_dir} "
                f"(available: {self.all_steps() or 'none'})")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, step: int, state: TrainState) -> TrainState:
        """Full restore: model + optimizer + schedule (reference --restore_step)."""
        payload = self._load(step)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.step = step
        state.micro_step = payload["micro_step"]
        if payload["acc_grads"] is not None:
            for p, g in zip(state.model.parameters(), payload["acc_grads"]):
                p.grad = g.to(p.device, p.dtype)
        return state

    def restore_model_only(self, step: int, state: TrainState) -> TrainState:
        """Warm start from another run's weights (reference --checkpoint)."""
        weights = self.model_state_dict(step)
        state.model.load_state_dict(weights, strict=True)
        return state

    def model_state_dict(self, step: int) -> dict:
        """The FastSpeech2 weights saved at `step` (what inference restores)."""
        return self._load(step)["model"]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.ckpt_dir))
                      if m)
