"""Losses: FastSpeech2 masked reconstruction + TacoSpawn speaker-prior NLL
(port of masg_tpu/models/loss.py).

Reference: model/loss.py:5-105. The reference's masked_select + mean is a
mask-weighted mean here (sum(x * mask) / max(sum(mask), 1)), numerically the
same for the same mask.

Under a sharded data mesh (`parallel.mesh.DataMesh`) each rank holds some
rows of the global batch: a loss here is then this rank's PART of the
global one, its rows' sum over the GLOBAL count (all-reduced), so that the
parts sum to the one-device loss and their gradients to its gradient, as
the global means of masg_tpu's sharded step. `mesh.sum` of a part gives the
loss itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import gmm as gmm_ops
from ..ops.gmm import DiagGMM
from .fastspeech2 import FS2Output


class FS2Losses(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    duration: torch.Tensor


def _masked_mean(err: torch.Tensor, valid: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean of err over the True positions of valid, whose dims lead err's;
    each valid position covers all of err's trailing dims (`mesh`: this
    rank's part of the global mean)."""
    per_pos = 1
    for s in err.shape[valid.dim():]:
        per_pos *= s
    validf = valid.to(err.dtype)
    vb = validf.reshape(validf.shape + (1,) * (err.dim() - valid.dim()))
    count = validf.sum() * per_pos
    if mesh is not None:
        count = mesh.sum(count)
    return (err * vb).sum() / torch.clamp(count, min=1.0)


def fastspeech2_loss(output: FS2Output, mel_targets: torch.Tensor,
                     pitch_targets: torch.Tensor, energy_targets: torch.Tensor,
                     duration_targets: torch.Tensor,
                     pitch_feature_level: str = "phoneme_level",
                     energy_feature_level: str = "phoneme_level", mesh=None) -> FS2Losses:
    """Masked L1 on mels, masked MSE on pitch/energy/log-duration
    (reference loss.py:19-92); under `mesh`, this rank's parts."""
    src_valid = ~output.src_pad_mask
    mel_valid = ~output.mel_pad_mask
    mel_targets = mel_targets[:, :output.mel_pad_mask.shape[1], :]

    # the reference takes the log target in float32 whatever the model dtype
    # (`.float()`, model/loss.py:42); a float64 log rounded to float32 is the
    # correctly rounded float32 log, as masg_tpu computes it under x64
    log_dtype = torch.promote_types(output.log_duration_prediction.dtype, torch.float32)
    log_d_targets = torch.log(duration_targets.to(torch.float64) + 1.0)
    log_d_targets = log_d_targets.to(torch.float32).to(log_dtype).detach()

    pv = src_valid if pitch_feature_level == "phoneme_level" else mel_valid
    ev = src_valid if energy_feature_level == "phoneme_level" else mel_valid

    pitch_loss = _masked_mean((output.pitch_prediction - pitch_targets) ** 2, pv, mesh)
    energy_loss = _masked_mean((output.energy_prediction - energy_targets) ** 2, ev, mesh)
    duration_loss = _masked_mean((output.log_duration_prediction - log_d_targets) ** 2,
                                 src_valid, mesh)
    mel_loss = _masked_mean((output.mel - mel_targets).abs(), mel_valid, mesh)
    postnet_mel_loss = _masked_mean((output.postnet_mel - mel_targets).abs(), mel_valid, mesh)

    total = mel_loss + postnet_mel_loss + duration_loss + pitch_loss + energy_loss
    return FS2Losses(total=total, mel=mel_loss, postnet_mel=postnet_mel_loss,
                     pitch=pitch_loss, energy=energy_loss, duration=duration_loss)


def speaker_prior_log_prob(speaker_emb: torch.Tensor, gmm: DiagGMM, mesh=None
                           ) -> torch.Tensor:
    """mean_b GMM_b.log_prob(detach(speaker_emb_b)) (`mesh`: this rank's
    part of the mean over the global batch).

    Reference SpeakerMetaEncLoss (loss.py:94-105): the embedding is detached
    so the prior chases the table, not the reverse; the train step NEGATES
    this value (train.py:163-166), i.e. the loss contribution is
    -speaker_prior_log_prob.
    """
    logp = gmm_ops.log_prob(gmm, speaker_emb.detach())
    if mesh is None or mesh.parts == 1:
        return logp.mean()
    return logp.sum() / (logp.shape[0] * mesh.parts)
