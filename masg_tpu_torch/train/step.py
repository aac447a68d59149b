"""Train and eval steps (port of masg_tpu/train/step.py).

The reference runs separate backward passes for the FastSpeech2 loss and the
negated speaker-prior log-likelihood (train.py:151-197); as in masg_tpu they
are ONE scalar here, total - eloss, with `detach` where masg_tpu has
`stop_gradient`. Each step: forward (train mode: dropout, batch-statistics
BatchNorm), loss, one backward, then, every `grad_acc_step` micro-batches,
clip the mean gradient and take one Adam update with the Noam schedule.

The `--use_clf` and ganlike variants (ROADMAP.md queue 1 item 8) and JDIT
(item 11) are not ported yet.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.fastspeech2 import FastSpeech2, FS2Output
from ..models.loss import FS2Losses, fastspeech2_loss, speaker_prior_log_prob
from .state import TrainState

_INT_KEYS = ("speakers", "texts", "src_lens", "mel_lens", "durations", "accents")
_HOST_KEYS = ("ids", "raw_texts")


class StepMetrics(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    duration: torch.Tensor
    speaker_prior: torch.Tensor  # eloss (mean GMM log-prob, pre-negation)
    dloss: torch.Tensor  # adversarial language loss: 0 until --use_clf is ported
    grad_norm: torch.Tensor  # global norm of this micro-batch's gradient, pre-clip


def unported(variant: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{variant}: not ported to masg_tpu_torch yet (ROADMAP.md queue 1 item {item})")


def batch_to_device(batch: Dict[str, np.ndarray], device, float_dtype: torch.dtype
                    ) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device`: id and length fields as int64,
    features in `float_dtype` (the model's parameter dtype)."""
    out = {}
    for k, v in batch.items():
        if k in _HOST_KEYS:
            continue
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, torch.long if k in _INT_KEYS else float_dtype)
    return out


def _forward(model: FastSpeech2, batch: Dict[str, torch.Tensor], train: bool) -> FS2Output:
    """Teacher-forced forward on a device batch."""
    model.train(train)
    return model(batch["speakers"], batch["texts"], batch["src_lens"],
                 batch["mels"].shape[1], mel_lens=batch["mel_lens"],
                 p_targets=batch["pitches"], e_targets=batch["energies"],
                 d_targets=batch["durations"], accents=batch.get("accents"),
                 speaker_meta=batch["speaker_meta"])


def _autocast(device: torch.device, dtype: Optional[torch.dtype]):
    """bf16 compute with f32 parameters (`--bf16`), or nothing."""
    return torch.autocast(device.type, dtype=dtype) if dtype is not None else nullcontext()


def _losses(model, batch, train, pitch_feature_level, energy_feature_level,
            use_speaker_prior) -> Tuple[torch.Tensor, FS2Losses, torch.Tensor, FS2Output]:
    out = _forward(model, batch, train)
    losses = fastspeech2_loss(out, batch["mels"], batch["pitches"], batch["energies"],
                              batch["durations"], pitch_feature_level, energy_feature_level)
    total = losses.total
    eloss = torch.zeros((), dtype=total.dtype, device=total.device)
    if use_speaker_prior and out.speaker_gmm is not None:
        eloss = speaker_prior_log_prob(out.speaker_emb, out.speaker_gmm)
        total = total - eloss  # maximise the log-likelihood (train.py:163-166)
    return total, losses, eloss, out


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over all gradients, as clip_grad_norm_ reduces it."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def make_train_step(model: FastSpeech2, pitch_feature_level: str = "phoneme_level",
                    energy_feature_level: str = "phoneme_level",
                    use_speaker_prior: bool = True, use_clf: bool = False,
                    use_jdit: bool = False, autocast_dtype: Optional[torch.dtype] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor], Optional[int]],
                                  Tuple[TrainState, StepMetrics]]:
    """The train step closure: `train_step(state, batch, seed)`.

    `seed`, when given, seeds torch's generators first, so a step's dropout
    masks are a function of the seed alone (the trainer passes one derived
    from (run seed, step)). `autocast_dtype` (bf16) runs forward and loss
    under `torch.autocast`.
    """
    if use_clf:
        raise unported("--use_clf (the adversarial language discriminator)", 8)
    if use_jdit:
        raise unported("use_jdit (the JDIT teacher)", 11)
    device = next(model.parameters()).device

    def loss_fn(model: FastSpeech2, batch: Dict[str, torch.Tensor]):
        """(total, losses, eloss, output) of one train-mode forward."""
        with _autocast(device, autocast_dtype):
            return _losses(model, batch, True, pitch_feature_level, energy_feature_level,
                           use_speaker_prior)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: Optional[int] = None) -> Tuple[TrainState, StepMetrics]:
        if seed is not None:
            torch.manual_seed(seed)
        params = [p for p in state.model.parameters() if p.requires_grad]
        k = state.grad_acc_step
        # the mean gradient of the micro-batches so far: this one's goes apart
        acc = [p.grad for p in params] if state.micro_step else None
        for p in params:
            p.grad = None
        total, losses, eloss, _ = loss_fn(state.model, batch)
        total.backward()
        for p in params:  # one the forward did not reach (no accents) counts as zero
            if p.grad is None:
                p.grad = torch.zeros_like(p)

        if k == 1:
            grad_norm = torch.nn.utils.clip_grad_norm_(params, state.grad_clip_thresh)
            update = True
        else:  # optax.MultiSteps: the mean of k micro-batch gradients, one update
            grad_norm = global_norm([p.grad for p in params])
            for i, p in enumerate(params):
                g = p.grad / k
                p.grad = g if acc is None else acc[i] + g
            state.micro_step += 1
            update = state.micro_step == k
            if update:
                torch.nn.utils.clip_grad_norm_(params, state.grad_clip_thresh)
        if update:
            state.optimizer.step()
            state.scheduler.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.micro_step = 0
        state.step += 1
        zero = torch.zeros((), dtype=losses.total.dtype, device=losses.total.device)
        metrics = StepMetrics(*(x.detach() for x in losses), speaker_prior=eloss.detach(),
                              dloss=zero, grad_norm=grad_norm.detach())
        return state, metrics

    train_step.loss_fn = loss_fn  # exposed for parity tooling, as in masg_tpu
    return train_step


def make_eval_step(model: FastSpeech2, pitch_feature_level: str = "phoneme_level",
                   energy_feature_level: str = "phoneme_level",
                   use_speaker_prior: bool = True,
                   autocast_dtype: Optional[torch.dtype] = None
                   ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                 Tuple[FS2Losses, torch.Tensor, FS2Output]]:
    """Validation step: losses on a batch with dropout off and BatchNorm on
    its running statistics, no update (reference evaluate.py:18-75)."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with _autocast(device, autocast_dtype):
            _, losses, eloss, out = _losses(state.model, batch, False, pitch_feature_level,
                                            energy_feature_level, use_speaker_prior)
        return losses, eloss, out

    return eval_step
