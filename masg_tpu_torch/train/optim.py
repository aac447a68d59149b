"""Optimizer: Adam + Noam LR schedule with step anneals (port of
masg_tpu/train/optim.py).

The reference's ScheduledOptim (model/optimizer.py:5-51):
  lr(step) = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
             * anneal_rate^{#(anneal_steps < step)}
where `step` counts from 1 at the first update. masg_tpu rebuilt torch's
Adam (`scale_by_adam_torch`) and `clip_grad_norm_` (`clip_by_global_norm_torch`,
with its 1e-6 fudge) in optax; here they are torch's own: `torch.optim.Adam`
on its single-tensor path (`foreach=False`, the math masg_tpu copies), and
`torch.nn.utils.clip_grad_norm_` in the train step. The schedule drives
`LambdaLR` over a base lr of 1.0, so the first update uses schedule(0).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence, Tuple

import torch

from ..core.config import OptimizerConfig


def noam_schedule(d_model: int, warm_up_step: int,
                  anneal_steps: Sequence[int] = (300000, 400000, 500000),
                  anneal_rate: float = 0.3) -> Callable[[int], float]:
    """count (updates so far) -> lr of the next update, in float64.

    step = count + 1; step^-0.5 as 1 / sqrt(step), both correctly rounded,
    as masg_tpu computes it.
    """
    init_lr = float(d_model) ** -0.5

    def schedule(count: int) -> float:
        step = float(count) + 1.0
        lr = min(1.0 / math.sqrt(step), step * float(warm_up_step) ** -1.5)
        for s in anneal_steps:
            if step > s:
                lr = lr * anneal_rate
        return init_lr * lr

    return schedule


def make_optimizer(opt_cfg: OptimizerConfig, d_model: int,
                   params: Iterable[torch.nn.Parameter]
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """(Adam, its Noam LambdaLR). Weight decay is Adam's L2-into-gradient,
    after the clip, as in masg_tpu's chain. Clipping and gradient
    accumulation belong to the train step (`train/step.py`)."""
    opt = torch.optim.Adam(params, lr=1.0, betas=tuple(opt_cfg.betas), eps=opt_cfg.eps,
                           weight_decay=opt_cfg.weight_decay, foreach=False)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, noam_schedule(d_model, opt_cfg.warm_up_step, opt_cfg.anneal_steps,
                           opt_cfg.anneal_rate))
    return opt, sched


def set_schedule_count(sched: torch.optim.lr_scheduler.LambdaLR, count: int) -> None:
    """Position the schedule after `count` updates (a run resumed from
    another package's optimizer state)."""
    sched.last_epoch = count
    for group, base, fn in zip(sched.optimizer.param_groups, sched.base_lrs, sched.lr_lambdas):
        group["lr"] = base * fn(count)
    sched._last_lr = [g["lr"] for g in sched.optimizer.param_groups]
