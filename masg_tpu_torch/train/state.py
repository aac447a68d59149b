"""Train state: the model (parameters + PostNet BatchNorm statistics), its
optimizer and schedule, and the step counters (port of masg_tpu/train/state.py).

masg_tpu's optax chain holds the clip and the gradient accumulation
(`optax.MultiSteps`); here the train step does both, reading their settings
from this state. While micro-batches accumulate, their mean gradient so far
lives in the parameters' `.grad`.

Under bf16 parameter storage (masg_tpu's `with_master_params`, optim.py:
225-270) `master` holds an f32 copy of every parameter. The optimizer and
the clip act on it, and after each update the model's parameters become
bf16(master).

`fs2` and `discriminator` say which part of `model` is the FastSpeech2 and
which the discriminator trained with it (ganlike's `GANLike`); the clip, the
checkpoints, the eval step and the Trainer read them.

On a model axis (`model_axis`) the split parameters (`shard_dims`) hold this
rank's shard, and so do their master copies and Adam moments: Adam is
elementwise, so it steps the shards as it would the whole tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from ..core.config import OptimizerConfig
from ..models.ganlike import GANLike
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
    master: Optional[List[torch.Tensor]] = None  # f32 copies under bf16 storage
    # per parameter of `params()`: the dimension its shard splits along on the
    # model axis, or None (whole); read once from the layers
    shard_dims: Optional[List[Optional[int]]] = None

    def __post_init__(self):
        if self.shard_dims is None:
            from ..parallel.mesh import sharded_names

            names = sharded_names(self.model) if self.model_axis is not None else {}
            self.shard_dims = [names.get(n) for n, p in self.model.named_parameters()
                               if p.requires_grad]

    @property
    def fs2(self) -> torch.nn.Module:
        """The FastSpeech2 being trained (ganlike: `model`'s FastSpeech2 half)."""
        return self.model.model if isinstance(self.model, GANLike) else self.model

    @property
    def model_axis(self):
        """The FastSpeech2's model axis (`parallel.tensor.ModelAxis`), or None."""
        return getattr(self.fs2, "model_axis", None)

    @property
    def shard_mask(self) -> List[bool]:
        """Per parameter of `params()`: whether it holds this rank's shard of
        a split weight (all False without a model axis)."""
        return [d is not None for d in self.shard_dims]

    @property
    def discriminator(self) -> Optional[torch.nn.Module]:
        """The discriminator trained jointly with it (ganlike), else None."""
        return self.model.discriminator if isinstance(self.model, GANLike) else None

    def params(self) -> List[torch.nn.Parameter]:
        """The model's trainable parameters, in the optimizer's order."""
        return [p for p in self.model.parameters() if p.requires_grad]

    def clip_mask(self) -> List[bool]:
        """Per parameter of `params()`: whether the clip covers it, which is
        whether it is the FastSpeech2's (masg_tpu's `clip_subtree="model"`
        under ganlike, loop.py:579-587)."""
        clipped = {id(p) for p in self.fs2.parameters()}
        return [id(p) in clipped for p in self.params()]

    @torch.no_grad()
    def sync_master(self) -> None:
        """master = f32(params), after weights were loaded into the model."""
        if self.master is not None:
            for m, p in zip(self.master, self.params()):
                m.copy_(p)


def create_train_state(model: torch.nn.Module, opt_cfg: OptimizerConfig, d_model: int,
                       param_storage: str = "f32") -> TrainState:
    """The optimizer over `model`'s trainable parameters, or, when
    `param_storage` is "bf16" or "bf16_moments", over an f32 master copy of
    them (the caller has put the model's parameters in bf16)."""
    params = [p for p in model.parameters() if p.requires_grad]
    master = None
    if param_storage != "f32":
        master = [p.detach().to(torch.float32).clone() for p in params]
    optimizer, scheduler = make_optimizer(opt_cfg, d_model, master or params, param_storage)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      grad_clip_thresh=opt_cfg.grad_clip_thresh,
                      grad_acc_step=max(int(opt_cfg.grad_acc_step), 1), master=master)
