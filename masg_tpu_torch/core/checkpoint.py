"""Checkpoint manager (port of masg_tpu/core/checkpoint.py).

The reference's semantics (train.py:271-285, utils/model.py:11-34):
- every save_step, save the model (parameters + BatchNorm statistics), the
  optimizer and the schedule, keyed by step;
- `--restore_step N` restores all of them and the step counter;
- `--checkpoint path` warm-starts the MODEL only, from another run.

One `torch.save` file per step, `<ckpt_dir>/<step>.pth.tar`, with the
FastSpeech2 weights under "model" as the reference's checkpoints hold them,
so `infer.synthesis.load_model` reads it. A ganlike run (a `GANLike` train
model: `TrainState.fs2` and `TrainState.discriminator`) keeps its halves
apart as the reference's `{"model", "discriminator", "optimizer"}`
(train_ganlike.py:247-257). Under
bf16 parameter storage the f32 master copy is saved under "master" and
restored with the rest. `max_to_keep` keeps the newest N.

The optimizer is saved in the reference's layout: its per-parameter state
keyed by position in the reference's `named_parameters()` order
(`compat/torch_order.py`), grad-less tables and bins included, so masg_tpu's
`import_torch_optimizer` and the reference read it, and the file does not
depend on how many processes trained it. The port's own keys (`scheduler`,
`micro_step`, `acc_grads`, `master`) ride beside it; a reference-format
`{"model"[, "discriminator"], "optimizer"}` file, which lacks them, restores
at micro-step 0 with no accumulated gradient and the schedule at Adam's step
count.

Tensor parallelism does not change the file either: on a model axis `save`
gathers every split parameter, its Adam moments, master copy and
accumulated gradient over the model group (every rank of the group calls
it; model rank 0 writes), and `restore`/`restore_model_only` read the whole
file and keep this rank's shard (`parallel.mesh.shard_state`).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from ..compat.torch_order import ganlike_param_order, ge2e_param_order, reference_param_order
from ..parallel.mesh import shard_state, sharded_names, unshard_state, unshard_tensor
from ..train.optim import set_schedule_count
from ..train.state import TrainState

_MOMENTS = ("exp_avg", "exp_avg_sq")

_NAME = re.compile(r"^(\d+)\.pth\.tar$")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{step}.pth.tar")

    def save(self, step: int, state: TrainState) -> None:
        """Write `step`'s checkpoint. On a model axis every rank of the model
        group calls it (the gathers are collectives); model rank 0 writes."""
        axis = state.model_axis
        dims = state.shard_dims

        def whole(t, dim):
            return t if dim is None else unshard_tensor(t, dim, axis)

        opt = state.optimizer.state_dict()
        if axis is not None:
            opt = dict(opt, state={i: {k: whole(v, dims[i]) if k in _MOMENTS else v
                                       for k, v in st.items()}
                                   for i, st in opt["state"].items()})
        payload = {
            "model": unshard_state(state.fs2.state_dict(),
                                   sharded_names(state.fs2) if axis else {}, axis),
            "optimizer": _to_reference_layout(state, opt),
            "scheduler": state.scheduler.state_dict(),
            "step": step,
            "micro_step": state.micro_step,
            # the accumulated gradient of an update still in progress
            "acc_grads": ([whole(p.grad, d) for p, d in zip(state.params(), dims)]
                          if state.micro_step else None),
            "master": (None if state.master is None else
                       [whole(m, d) for m, d in zip(state.master, dims)]),
        }
        if axis is not None and axis.rank != 0:
            return
        if state.discriminator is not None:
            payload["discriminator"] = state.discriminator.state_dict()
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
        axis = state.model_axis
        dims = state.shard_dims

        def mine(t, dim):
            return t if dim is None else axis.shard(t, dim)

        state.fs2.load_state_dict(_shard_model(state, payload["model"]), strict=True)
        if state.discriminator is not None:
            state.discriminator.load_state_dict(payload["discriminator"], strict=True)
        if (payload.get("master") is None) != (state.master is None):
            raise ValueError(f"checkpoint {self.path(step)} and this run differ in "
                             f"param_storage (f32 master copy saved: "
                             f"{payload.get('master') is not None})")
        if state.master is not None:
            with torch.no_grad():
                for m, saved, d in zip(state.master, payload["master"], dims):
                    m.copy_(mine(saved, d))
        opt = _from_reference_layout(state, payload["optimizer"], self.path(step))
        if axis is not None:
            opt["state"] = {i: {k: mine(v, dims[i]) if k in _MOMENTS else v
                                for k, v in st.items()} for i, st in opt["state"].items()}
        state.optimizer.load_state_dict(opt)
        if "scheduler" in payload:
            state.scheduler.load_state_dict(payload["scheduler"])
        else:  # a reference-format file: the schedule follows Adam's count
            adam = opt["state"]
            set_schedule_count(state.scheduler,
                               int(next(iter(adam.values()))["step"]) if adam else 0)
        state.step = step
        state.micro_step = payload.get("micro_step", 0)
        if payload.get("acc_grads") is not None:
            for p, g, d in zip(state.params(), payload["acc_grads"], dims):
                p.grad = mine(g, d).to(p.device, p.dtype)
        return state

    def restore_model_only(self, step: int, state: TrainState) -> TrainState:
        """Warm start of the FastSpeech2 weights from another run's (reference
        --checkpoint); under bf16 storage the master copy follows them."""
        weights = self.model_state_dict(step)
        state.fs2.load_state_dict(_shard_model(state, weights), strict=True)
        state.sync_master()
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


def _shard_model(state: TrainState, weights: dict) -> dict:
    """This rank's shard of whole FastSpeech2 weights."""
    axis = state.model_axis
    return shard_state(weights, sharded_names(state.fs2) if axis else {}, axis)


def _fs2_order(model: torch.nn.Module) -> List[str]:
    """`reference_param_order` for a FastSpeech2, its config read off its names."""
    names = {n for n, _ in model.named_parameters()}

    def count(prefix: str) -> int:
        return len({n[len(prefix):].split(".")[0] for n in names if n.startswith(prefix)})

    return reference_param_order(count("encoder.layer_stack."), count("decoder.layer_stack."),
                                 multi_speaker="speaker_emb.weight" in names,
                                 use_jdit=any(n.startswith("jdit.") for n in names),
                                 postnet_convs=count("postnet.convolutions."))


def _reference_order(state: TrainState) -> Tuple[List[str], List[str]]:
    """(the optimizer's parameter names in the port's order, the reference's
    order of the same optimizer)."""
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    ref = _fs2_order(state.fs2)
    if state.discriminator is not None:
        disc = {n for n, _ in state.discriminator.named_parameters()}
        n_layers = sum(1 for n in disc if n.startswith("LSTM_stack.weight_ih_l"))
        ref = ganlike_param_order(ref, ge2e_param_order(
            n_layers, use_da=any(n.startswith("da_classifier.") for n in disc)))
    missing = set(names) - set(ref)
    assert not missing, f"parameters outside the reference order: {sorted(missing)}"
    return names, ref


def _to_reference_layout(state: TrainState, opt: dict) -> dict:
    names, ref = _reference_order(state)
    pos = {n: i for i, n in enumerate(ref)}
    (group,) = opt["param_groups"]
    return {"state": {pos[names[i]]: s for i, s in opt["state"].items()},
            "param_groups": [dict(group, params=list(range(len(ref))))]}


def _from_reference_layout(state: TrainState, opt: dict, path: str) -> dict:
    names, ref = _reference_order(state)
    (group,) = opt["param_groups"]
    if len(group["params"]) != len(ref):
        raise ValueError(f"{path}: its optimizer covers {len(group['params'])} parameters, "
                         f"the reference order of this model {len(ref)}")
    pos = {n: i for i, n in enumerate(ref)}
    return {"state": {i: opt["state"][pos[n]] for i, n in enumerate(names)
                      if pos[n] in opt["state"]},
            "param_groups": [dict(group, params=list(range(len(names))))]}
