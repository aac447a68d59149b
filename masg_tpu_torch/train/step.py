"""Train and eval steps (port of masg_tpu/train/step.py).

The reference runs separate backward passes for the FastSpeech2 loss, the
negated speaker-prior log-likelihood and the scheduled adversarial language
loss (train.py:151-197); as in masg_tpu they are ONE scalar here, with
`detach` where masg_tpu has `stop_gradient`. Each step: forward (train mode:
dropout, batch-statistics BatchNorm), loss, one backward, then, every
`grad_acc_step` micro-batches, clip the mean gradient and take one Adam
update with the Noam schedule (on the f32 master under bf16 storage).

Three variants:
- plain (`make_train_step`): total = FS2 losses - speaker prior; with
  `use_jdit` the JDIT teacher's unmasked mel MSE joins the total
  (masg_tpu step.py:134-136);
- `--use_clf` (`make_train_step(use_clf=True, discriminator=...)`): a second
  train-mode forward on a speaker-shuffled copy of the batch, its pre-PostNet
  mel chunked into 150-frame windows and scored by a FROZEN GE2E
  discriminator; its BCE against the shuffled speakers' language joins the
  total under a sigmoid warm-up schedule;
- ganlike (`make_ganlike_train_step`): the same, with the discriminator
  trained jointly under the one optimizer against jittered labels.

The JDIT teacher's dropout masks come from a `torch.Generator`: in a train
step one seeded from the step's seed, in the eval step one seeded from 0 on
every call (masg_tpu passes `PRNGKey(0)`, step.py:64-66), since its prenet
dropout stays on in eval.

Data parallelism: every step takes a `mesh` (`parallel.mesh.DataMesh`, for
this batch: `DataMesh.for_batch`) and this rank's rows of the batch
(`DataMesh.shard_batch`). Its losses are then this rank's parts of the
global masked means and PostNet's BatchNorm takes the global statistics, so
after `mesh.reduce_grads` sums the ranks' gradients (after every backward,
before the clip; masg_tpu's sharded `jax.grad` reduces each micro-batch too,
and StepMetrics.grad_norm is that micro-batch's global norm) every rank
holds the one-device gradient and takes the one-device update. The metrics
are the global losses. `--use_clf`/ganlike shuffle speakers over the whole
batch: `shard_batch` turns a global `reorder` into the rows' shuffled
speakers, and the trainer draws it on the host, the same on every rank.
Dropout masks depend on the rank's seed, so with dropout on a
data-parallel run is another draw than one device's.

Tensor parallelism: on a model axis (`TrainState.model_axis`; the mesh's
data collectives then run over its data group) every model rank computes
the whole loss of its rows, and its gradients are those of its shards and
of the replicated parameters (averaged over the model group, so that the
replicas stay equal bit for bit on a card). The clip's norm, and
StepMetrics.grad_norm, sum the shards' squares over the model group and
count the replicated parameters once. Every model rank seeds from the data
rank, so the masks on replicated activations are the same on all of them.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.fastspeech2 import FastSpeech2, FS2Output
from ..models.ganlike import GANLike
from ..models.loss import FS2Losses, fastspeech2_loss, speaker_prior_log_prob
from ..models.speaker_encoder import (SpeechEmbedder, bce_with_logits_sum, chunk_mels,
                                      discriminator_mode)
from ..parallel.distributed import all_reduce_, reduced
from .state import TrainState

# the speaker_meta column of the binary language label (reference train.py:185)
LANG_META_INDEX = 2
_INT_KEYS = ("speakers", "texts", "src_lens", "mel_lens", "durations", "accents", "reorder",
             "reorder_speakers")
CHUNK_FRAMES = 150  # the discriminator's window (`chunk_mels`)
_HOST_KEYS = ("ids", "raw_texts")


class StepMetrics(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    duration: torch.Tensor
    speaker_prior: torch.Tensor  # eloss (mean GMM log-prob, pre-negation)
    dloss: torch.Tensor  # adversarial language loss (0 on the plain step)
    grad_norm: torch.Tensor  # global norm of this micro-batch's gradient, pre-clip


def batch_to_device(batch: Dict[str, np.ndarray], device, float_dtype: torch.dtype
                    ) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device`: id and length fields (and an
    injected `reorder`) as int64, features in `float_dtype` (the model's
    parameter dtype)."""
    out = {}
    for k, v in batch.items():
        if k in _HOST_KEYS:
            continue
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, torch.long if k in _INT_KEYS else float_dtype)
    return out


def _forward(model: FastSpeech2, batch: Dict[str, torch.Tensor], train: bool,
             speakers: Optional[torch.Tensor] = None,
             speaker_meta: Optional[torch.Tensor] = None,
             teacher_gen: Optional[torch.Generator] = None, mesh=None) -> FS2Output:
    """Teacher-forced forward on a device batch (optionally for other
    speakers); with `teacher_gen` the JDIT teacher runs too."""
    model.train(train)
    return model(batch["speakers"] if speakers is None else speakers, batch["texts"],
                 batch["src_lens"], batch["mels"].shape[1], mel_lens=batch["mel_lens"],
                 p_targets=batch["pitches"], e_targets=batch["energies"],
                 d_targets=batch["durations"], accents=batch.get("accents"),
                 speaker_meta=batch["speaker_meta"] if speaker_meta is None else speaker_meta,
                 mels=batch["mels"] if teacher_gen is not None else None,
                 jdit_generator=teacher_gen, mesh=mesh if train else None)


def draw_shuffle(batch: Dict[str, np.ndarray], seed: int, jitter: bool,
                 max_frames: int) -> Dict[str, np.ndarray]:
    """The host batch with the speaker shuffle of `--use_clf`/ganlike drawn
    from `seed` (`reorder`, a permutation of the whole batch) and, with
    `jitter`, ganlike's label jitter (`lang_jitter`, U[0, 1) per chunk of
    each row; `max_frames`: the model's max_seq_len, which caps the mel the
    chunks cut). The trainer draws them here so that every rank of a
    data-parallel run shuffles the one global batch alike."""
    rng = np.random.default_rng(seed)
    b = len(batch["speakers"])
    out = dict(batch, reorder=rng.permutation(b))
    if jitter:
        n_chunks = min(np.asarray(batch["mels"]).shape[1], max_frames) // CHUNK_FRAMES + 1
        out["lang_jitter"] = rng.random(b * n_chunks)
    return out


def jdit_generator(device: torch.device, seed: int) -> torch.Generator:
    """The generator of the JDIT teacher's dropout masks on `device`."""
    return torch.Generator(device=device).manual_seed(seed)


def _autocast(device: torch.device, dtype: Optional[torch.dtype]):
    """bf16 compute with f32 parameters (`--bf16`), or nothing."""
    return torch.autocast(device.type, dtype=dtype) if dtype is not None else nullcontext()


def _losses(model, batch, train, pitch_feature_level, energy_feature_level,
            use_speaker_prior, teacher_gen: Optional[torch.Generator] = None, mesh=None
            ) -> Tuple[torch.Tensor, FS2Losses, torch.Tensor, FS2Output]:
    """(objective, losses, eloss, output); under `mesh`, this rank's parts."""
    out = _forward(model, batch, train, teacher_gen=teacher_gen, mesh=mesh)
    losses = fastspeech2_loss(out, batch["mels"], batch["pitches"], batch["energies"],
                              batch["durations"], pitch_feature_level, energy_feature_level,
                              mesh)
    total = losses.total
    if out.mel_jdit is not None:
        # plain (unmasked) MSE, as in the reference (train.py:150-154)
        se = (out.mel_jdit - batch["mels"].to(out.mel_jdit.dtype)) ** 2
        parts = 1 if mesh is None else mesh.parts
        total = total + (se.mean() if parts == 1 else se.sum() / (se.numel() * parts))
    eloss = torch.zeros((), dtype=total.dtype, device=total.device)
    if use_speaker_prior and out.speaker_gmm is not None:
        eloss = speaker_prior_log_prob(out.speaker_emb, out.speaker_gmm, mesh)
        total = total - eloss  # maximise the log-likelihood (train.py:163-166)
    return total, losses, eloss, out


def global_norm(grads, shard_mask=None, axis=None) -> torch.Tensor:
    """sqrt(sum of squares) over all gradients, as clip_grad_norm_ reduces it.
    On a model `axis` the grads flagged in `shard_mask` are this rank's
    shards: their squares are summed over the model group, the replicated
    ones counted once."""
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    if axis is None:
        return torch.linalg.vector_norm(norms)
    sq = norms.square()
    split = torch.tensor(shard_mask, device=sq.device)
    return torch.sqrt(reduced(sq[split].sum(), axis.group) + sq[~split].sum())


def _clip(tensors, shard_mask, axis, max_norm: float) -> torch.Tensor:
    """clip_grad_norm_ of `tensors`' gradients, by their global norm on a
    model `axis` (the same coefficient as torch's: max_norm / (norm + 1e-6),
    at most 1). Returns the norm."""
    if axis is None:
        return torch.nn.utils.clip_grad_norm_(tensors, max_norm)
    grads = [t.grad for t in tensors]
    norm = global_norm(grads, shard_mask, axis)
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return norm


def adversarial_schedule(step: int, total_step: int) -> float:
    """The sigmoid warm-up of the language loss, 2 / (1 + exp(-10 p)) - 1 at
    p = (step + 1) / total_step (reference train.py:195-196, whose step
    counter starts at 1 while `state.step` counts from 0). In f32 whatever
    the model's dtype, as masg_tpu computes it from `state.step.astype(f32)`:
    an f64 trajectory moves by the f32 rounding of this factor."""
    s = torch.tensor(float(step), dtype=torch.float32)
    return float(2.0 / (1.0 + torch.exp(-10.0 * ((s + 1.0) / total_step))) - 1.0)


def ge2e_basis(n_mels: int = 80) -> np.ndarray:
    """(n_mels, n_mels) change of basis A = FB55ᵀ·pinv(FB0ᵀ), rounded to f32:
    a linear mel on the model's fmin-0 filterbank -> the GE2E encoder's
    fmin-55 one (masg_tpu's `clf_featurization="ge2e"`, step.py:109-117)."""
    from ..audio.stft import mel_filterbank

    fb0 = mel_filterbank(n_mels, 1024, 22050, 0.0, 8000.0)  # (n_freqs, n_mels)
    fb55 = mel_filterbank(n_mels, 1024, 22050, 55.0, 8000.0)
    return (fb55.T @ np.linalg.pinv(fb0.T)).astype(np.float32)


def _language_loss(model: FastSpeech2, discriminator: SpeechEmbedder,
                   batch: Dict[str, torch.Tensor], basis: Optional[torch.Tensor], jitter: bool,
                   mesh=None) -> Tuple[torch.Tensor, int]:
    """(BCE sum, number of chunks of the global batch) of the discriminator on
    a second train-mode forward for a speaker-shuffled batch (reference
    train.py:170-196, train_ganlike.py:140-170). PostNet's BatchNorm
    statistics update again, after the first forward's, as masg_tpu threads
    them. The shuffle comes from the batch when given (`reorder`, or the
    rows' `reorder_speakers`/`reorder_speaker_meta` of
    `DataMesh.shard_batch`; parity tests inject the reference's draws), as
    does `lang_jitter`, else from torch's generator. The discriminator runs
    in f32 outside autocast, on its own dtype, with its dropout off and its
    LSTM in train mode (`discriminator_mode`). Under `mesh` the BCE sum is
    this rank's rows' part."""
    bsz = batch["speakers"].shape[0]
    if "reorder_speakers" in batch:
        speakers, meta = batch["reorder_speakers"], batch["reorder_speaker_meta"]
    else:
        reorder = batch.get("reorder")
        if reorder is None:
            reorder = torch.randperm(bsz, device=batch["speakers"].device)
        speakers, meta = batch["speakers"][reorder], batch["speaker_meta"][reorder]
    out_x = _forward(model, batch, True, speakers=speakers, speaker_meta=meta, mesh=mesh)
    mel = out_x.mel
    if basis is not None:
        # feature log-mel -> linear mel -> GE2E (fmin 55) mel basis -> log,
        # differentiable so the adversarial gradient reaches the model
        mel = torch.log(torch.clamp(torch.exp(mel) @ basis.to(mel.dtype).T, min=1e-5))
    chunks = chunk_mels(mel, CHUNK_FRAMES)  # (B * n_chunks, 150, n_mels)
    n_chunks = chunks.shape[0] // bsz
    w = discriminator.projection.linear_layer.weight
    langs = meta[:, LANG_META_INDEX].repeat_interleave(n_chunks).to(w.dtype)
    if jitter:  # label jitter langs + U[0, 1) (train_ganlike.py:163)
        j = batch.get("lang_jitter")
        langs = langs + (torch.rand(langs.shape, device=langs.device, dtype=langs.dtype)
                         if j is None else j.to(langs.dtype))
    with torch.autocast(chunks.device.type, enabled=False):
        logits = discriminator_mode(discriminator)(chunks.to(w.dtype))["da_lang_logits"]
        return (bce_with_logits_sum(logits, langs),
                chunks.shape[0] * (1 if mesh is None else mesh.parts))


def _update(state: TrainState, total: torch.Tensor, mesh=None) -> torch.Tensor:
    """Backward of `total` (with `mesh`, the ranks' gradients summed), then
    (every `grad_acc_step` micro-batches) the clip and one optimizer +
    schedule step. Returns the micro-batch's global gradient norm before the
    clip."""
    params = state.params()
    k = state.grad_acc_step
    # the mean gradient of the micro-batches so far: this one's goes apart
    acc = [p.grad for p in params] if state.micro_step else None
    for p in params:
        p.grad = None
    total.backward()
    for p in params:  # one the forward did not reach (no accents) counts as zero
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        mesh.reduce_grads(params)
    axis = state.model_axis
    shard = state.shard_mask if axis is not None else None
    if axis is not None:
        # every model rank computes the replicated parameters' gradients; on a
        # card they were seen to differ in the last bits between ranks (cause
        # not traced; K1-K3 use no atomics): their mean keeps the replicas one
        # model, bit for bit
        replicated = [p.grad for p, s in zip(params, shard) if not s]
        all_reduce_(replicated, axis.group)
        for g in replicated:
            g.div_(axis.size)
    # the clip's norm is this gradient's when it covers every parameter of a
    # single micro-batch (over the master it is the f32 norm of the same values)
    grad_norm = (None if state.discriminator is None and k == 1
                 else global_norm([p.grad for p in params], shard, axis))
    if k > 1:  # optax.MultiSteps: the mean of k micro-batch gradients, one update
        for i, p in enumerate(params):
            g = p.grad / k
            p.grad = g if acc is None else acc[i] + g
        state.micro_step += 1
        if state.micro_step < k:
            state.step += 1
            return grad_norm
    # the optimizer's tensors: the f32 master under bf16 storage
    opt = params if state.master is None else state.master
    if state.master is not None:
        for m, p in zip(state.master, params):
            m.grad = p.grad.to(m.dtype)
    mask = state.clip_mask()
    clip = [t for t, c in zip(opt, mask) if c]
    norm = _clip(clip, shard and [s for s, c in zip(shard, mask) if c], axis,
                 state.grad_clip_thresh)
    grad_norm = norm if grad_norm is None else grad_norm
    state.optimizer.step()
    state.scheduler.step()
    state.optimizer.zero_grad(set_to_none=True)
    if state.master is not None:
        with torch.no_grad():
            for m, p in zip(state.master, params):
                p.copy_(m)  # the stored parameters become bf16(master)
                p.grad = None
    state.micro_step = 0
    state.step += 1
    return grad_norm


def _metrics(losses: FS2Losses, eloss, dloss, grad_norm, mesh=None) -> StepMetrics:
    """The step's metrics; under `mesh`, the global losses (the parts summed,
    one all-reduce)."""
    parts = [x.detach() for x in (*losses, eloss, dloss)]
    if mesh is not None and mesh.parts > 1:
        parts = list(mesh.sum(torch.stack(parts)).unbind())
    return StepMetrics(*parts, grad_norm=grad_norm.detach())


def make_train_step(model: FastSpeech2, pitch_feature_level: str = "phoneme_level",
                    energy_feature_level: str = "phoneme_level",
                    use_speaker_prior: bool = True, use_clf: bool = False,
                    use_jdit: bool = False,
                    discriminator: Optional[SpeechEmbedder] = None,
                    lambd: float = 1.0, total_step: int = 30000,
                    clf_featurization: str = "model",
                    autocast_dtype: Optional[torch.dtype] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor], Optional[int]],
                                  Tuple[TrainState, StepMetrics]]:
    """The train step closure: `train_step(state, batch, seed, mesh=None)`.

    `seed`, when given, seeds torch's generators first, so a step's dropout
    masks (and `--use_clf`'s speaker shuffle) are a function of the seed
    alone (the trainer passes one derived from (run seed, step)).
    `autocast_dtype` (bf16) runs the FastSpeech2 forwards and loss under
    `torch.autocast`.

    `use_jdit` runs the JDIT teacher in the first forward and adds its mel
    MSE; its masks come from a generator seeded from `seed` (from a draw of
    torch's global generator when `seed` is None).

    `use_clf` needs `discriminator`, a GE2E `SpeechEmbedder` that stays frozen
    (no gradient to its parameters, outside the optimizer and the clip); the
    language loss joins the total as dloss * schedule(step) * lambd / number
    of chunks (masg_tpu step.py:143-177), against the speaker_meta column
    `LANG_META_INDEX`.
    `clf_featurization`: "model" feeds the predicted feature mels as they are
    (the reference's); "ge2e" first maps them into the GE2E encoder's fmin-55
    mel basis (`ge2e_basis`; masg_tpu's opt-in, beyond parity).
    """
    assert clf_featurization in ("model", "ge2e"), clf_featurization
    if use_clf:
        assert discriminator is not None, "use_clf needs a discriminator"
        discriminator.requires_grad_(False)
    device = next(model.parameters()).device
    basis = (torch.from_numpy(ge2e_basis()).to(device)
             if use_clf and clf_featurization == "ge2e" else None)

    def loss_fn(model: FastSpeech2, batch: Dict[str, torch.Tensor], step: int = 0,
                seed: int = 0, mesh=None):
        """(objective, losses, eloss, dloss, output) of the train-mode forward(s);
        `seed` seeds the JDIT teacher's masks; under `mesh`, this rank's parts."""
        gen = jdit_generator(device, seed) if use_jdit else None
        with _autocast(device, autocast_dtype):
            total, losses, eloss, out = _losses(model, batch, True, pitch_feature_level,
                                                energy_feature_level, use_speaker_prior, gen,
                                                mesh)
            dloss = torch.zeros((), dtype=total.dtype, device=total.device)
            if use_clf:
                dloss, n = _language_loss(model, discriminator, batch, basis,
                                          jitter=False, mesh=mesh)
                total = total + dloss * (adversarial_schedule(step, total_step) * lambd / n)
        return total, losses, eloss, dloss, out

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: Optional[int] = None, mesh=None) -> Tuple[TrainState, StepMetrics]:
        if seed is not None:
            torch.manual_seed(seed)
        elif use_jdit:  # the teacher's generator needs a seed of its own
            seed = int(torch.empty((), dtype=torch.int64).random_())
        total, losses, eloss, dloss, _ = loss_fn(state.model, batch, state.step, seed or 0,
                                                 mesh)
        grad_norm = _update(state, total, mesh)
        return state, _metrics(losses, eloss, dloss, grad_norm, mesh)

    train_step.loss_fn = loss_fn  # exposed for parity tooling, as in masg_tpu
    return train_step


def make_ganlike_train_step(model: GANLike, pitch_feature_level: str = "phoneme_level",
                            energy_feature_level: str = "phoneme_level",
                            use_speaker_prior: bool = True, lambd: float = 1.0,
                            total_step: int = 30000,
                            autocast_dtype: Optional[torch.dtype] = None):
    """The adversarial variant (masg_tpu step.py:208-282; reference
    train_ganlike.py:140-170, model/ganlike.py:10-45): FastSpeech2 and the
    discriminator (`model.model`, `model.discriminator`) train jointly under
    the state's one optimizer, against jittered labels langs + U[0, 1); the
    clip covers the FastSpeech2 half only (`TrainState.clip_mask`).
    Under gradient accumulation the dloss term is multiplied by the state's
    `grad_acc_step` k (`loss_fn`'s `grad_acc_step`): the reference scales
    total and eloss by 1/k but not dloss (train_ganlike.py:155,160,167), an
    asymmetry masg_tpu keeps."""
    device = next(model.parameters()).device

    def loss_fn(model: GANLike, batch: Dict[str, torch.Tensor], step: int = 0,
                grad_acc_step: int = 1, mesh=None):
        """(objective, losses, eloss, dloss, output) of the train-mode
        forwards; under `mesh`, this rank's parts."""
        with _autocast(device, autocast_dtype):
            total, losses, eloss, out = _losses(model.model, batch, True, pitch_feature_level,
                                                energy_feature_level, use_speaker_prior,
                                                mesh=mesh)
            dloss, n = _language_loss(model.model, model.discriminator, batch, None,
                                      jitter=True, mesh=mesh)
            total = total + dloss * (adversarial_schedule(step, total_step) * lambd
                                     * grad_acc_step / n)
        return total, losses, eloss, dloss, out

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: Optional[int] = None, mesh=None) -> Tuple[TrainState, StepMetrics]:
        if seed is not None:
            torch.manual_seed(seed)
        total, losses, eloss, dloss, _ = loss_fn(state.model, batch, state.step,
                                                 state.grad_acc_step, mesh)
        grad_norm = _update(state, total, mesh)
        return state, _metrics(losses, eloss, dloss, grad_norm, mesh)

    train_step.loss_fn = loss_fn
    return train_step


def make_eval_step(model: FastSpeech2, pitch_feature_level: str = "phoneme_level",
                   energy_feature_level: str = "phoneme_level",
                   use_speaker_prior: bool = True,
                   autocast_dtype: Optional[torch.dtype] = None
                   ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                 Tuple[FS2Losses, torch.Tensor, FS2Output]]:
    """Validation step: losses on a batch with dropout off and BatchNorm on
    its running statistics, no update (reference evaluate.py:18-75), on the
    state's FastSpeech2 (`TrainState.fs2`: ganlike's FastSpeech2 half). A
    JDIT teacher runs too, its always-on prenet dropout drawn from a
    generator seeded from 0 on every call, so eval repeats."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        gen = jdit_generator(device, 0) if state.fs2.jdit is not None else None
        with _autocast(device, autocast_dtype):
            _, losses, eloss, out = _losses(state.fs2, batch, False, pitch_feature_level,
                                            energy_feature_level, use_speaker_prior, gen)
        return losses, eloss, out

    return eval_step
