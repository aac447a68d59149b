"""Train state: the model (parameters + PostNet BatchNorm statistics), its
optimizer and schedule, and the step counters (port of masg_tpu/train/state.py).

masg_tpu's optax chain holds the clip and the gradient accumulation
(`optax.MultiSteps`); here the train step does both, reading their settings
from this state. While micro-batches accumulate, their mean gradient so far
lives in the parameters' `.grad`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.config import OptimizerConfig
from .optim import make_optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    grad_clip_thresh: float = 1.0
    grad_acc_step: int = 1
    step: int = 0  # train-step calls so far (micro-batches)
    micro_step: int = 0  # micro-batches accumulated toward the next update


def create_train_state(model: torch.nn.Module, opt_cfg: OptimizerConfig,
                       d_model: int) -> TrainState:
    optimizer, scheduler = make_optimizer(opt_cfg, d_model, model.parameters())
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      grad_clip_thresh=opt_cfg.grad_clip_thresh,
                      grad_acc_step=max(int(opt_cfg.grad_acc_step), 1))
