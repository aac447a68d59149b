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

`param_storage` (masg_tpu's `--param_storage`, optim.py:225-335): "f32"
(default); "bf16", bf16 parameters in the model with an f32 master copy
that the optimizer steps (the train state holds it, `train/state.py`);
"bf16_moments", the same with Adam's moments stored in bf16
(`BF16MomentAdam`, since `torch.optim.Adam` keeps its moments in the
parameter's dtype).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence, Tuple, Union

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


PARAM_STORAGES = ("f32", "bf16", "bf16_moments")


class BF16MomentAdam(torch.optim.Optimizer):
    """torch Adam's single-tensor math with `exp_avg`/`exp_avg_sq` stored in
    bf16: masg_tpu's `scale_by_adam_torch(moment_dtype=bf16)` (optim.py:62-107).

    The moment update runs in the gradient's dtype (f32 on the master) from
    the stored moments, stores the result rounded to bf16, and the step
    reads the stored (rounded) moments back, as masg_tpu's `_store` does:
      m = bf16(b1 m + (1 - b1) g);  v = bf16(b2 v + (1 - b2) g^2)
      p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)
    Weight decay is L2 into the gradient, as in torch's Adam.
    """

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.98), eps: float = 1e-9,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        assert closure is None, "BF16MomentAdam takes no closure"
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.bfloat16)
                st["step"] += 1
                t = float(st["step"])
                st["exp_avg"].copy_(st["exp_avg"].to(g.dtype) * b1 + (1 - b1) * g)
                st["exp_avg_sq"].copy_(st["exp_avg_sq"].to(g.dtype) * b2 + (1 - b2) * (g * g))
                bc2_sqrt = math.sqrt(1 - b2 ** t)
                denom = (st["exp_avg_sq"].to(p.dtype).sqrt() / bc2_sqrt).add_(group["eps"])
                p.addcdiv_(st["exp_avg"].to(p.dtype), denom,
                           value=-group["lr"] / (1 - b1 ** t))

    def load_state_dict(self, state_dict) -> None:
        # torch casts a loaded state to its parameter's dtype: store bf16 again
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].to(torch.bfloat16)


def make_optimizer(opt_cfg: OptimizerConfig, d_model: int,
                   params: Iterable[torch.Tensor], param_storage: str = "f32"
                   ) -> Tuple[Union[torch.optim.Adam, BF16MomentAdam],
                              torch.optim.lr_scheduler.LambdaLR]:
    """(Adam, its Noam LambdaLR) over `params` (the f32 master copy under
    bf16 storage). Weight decay is Adam's L2-into-gradient, after the clip,
    as in masg_tpu's chain. Clipping and gradient accumulation belong to the
    train step (`train/step.py`)."""
    if param_storage not in PARAM_STORAGES:
        raise ValueError(f"param_storage {param_storage!r} not in {PARAM_STORAGES}")
    kw = dict(lr=1.0, betas=tuple(opt_cfg.betas), eps=opt_cfg.eps,
              weight_decay=opt_cfg.weight_decay)
    if param_storage == "bf16_moments":
        opt = BF16MomentAdam(params, **kw)
    else:
        opt = torch.optim.Adam(params, foreach=False, **kw)
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
