"""Standalone GE2E speaker-encoder training (port of masg_tpu/train/ge2e.py).

Reference: Multilingual-.../train_speech_embedder.py:115-248. N language-
balanced speakers x M chunk utterances per batch; GE2E softmax loss on the
(N, M, N) similarity + binary language DA loss; three `torch.optim.Adam`s,
one per group, as the reference has them:
  main (LSTM + projection): lr, weight decay 1e-6, `clip_grad_norm_` 3.0;
  ge2e (w, b): lr, clip 1.0;
  DA head: 1e-3, weight decay 1e-6, clip 3.0, stepped only while the DA
  gate is on.

masg_tpu rebuilt this loop in optax, emulating two things of torch that are
native here: a group whose gradients are `None` (torch's set_to_none
`zero_grad`) does not step, its Adam moments frozen; and `nn.LSTM` carries
two biases per gate (masg_tpu's folded bias takes a doubled update, half
the weight decay and a double-counted clip norm). The port has both from
torch itself and emulates neither.

masg_tpu's fused `lax.scan` epoch has no counterpart: the port steps batch
by batch. Data parallelism (masg_tpu's mesh over the N x M chunk batch,
:365-401): every rank samples the same global batch and embeds its rows;
the embeddings are gathered (`DataMesh.gather_rows`, as XLA's all-gather)
before the (N, M, N) similarity, which every rank then computes whole and
counts 1 / n_data of as its part (the gather's backward sums the ranks'
cotangents, so the parts' summed gradients are the one-device gradient,
the similarity's w and b included, and not n times it). The DA loss, a sum
over rows, is each rank's rows' part. The three Adams step on the summed
gradient, so the replicas stay equal; rank 0 writes the checkpoints.

Faithfulness note (masg_tpu's): the shipped reference snapshot has the GE2E
backward commented out (train_speech_embedder.py:184, the
'sg_discriminator_woGE2E' ablation); `use_ge2e_backward=False` reproduces
that ablation, True trains the full method.
"""

from __future__ import annotations

import math
import os
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.speaker_encoder import (GE2ELossParams, SpeechEmbedder, bce_with_logits_sum,
                                      ge2e_loss, init_ge2e_params)
from ..parallel.mesh import DataMesh


class SpeakerChunkDataset:
    """`{dataset}_{spkr}_{gender}_{lang}.npy` chunk archives -> language-
    balanced N x M sampling (reference data_load.py:44-136). A host copy of
    masg_tpu's: the same `random.Random(seed)` draws, so the same seed gives
    the same batches in both packages."""

    def __init__(self, path: str, datasets: List[str], m_utts: int = 10,
                 tisv_frame: int = 150, seed: int = 0):
        import glob as g

        self.path = path
        self.m = m_utts
        self.tisv_frame = tisv_frame
        self.rng = random.Random(seed)
        self.files = []
        for d in datasets:
            self.files += sorted(
                os.path.basename(p) for p in g.glob(os.path.join(path, f"{d.lower()}*.npy"))
            )
        self.lang2files: Dict[str, List[str]] = {}
        for f in self.files:
            lang = self.decode(f)["language"]
            self.lang2files.setdefault(lang, []).append(f)
        self.langs = sorted(self.lang2files)
        if not self.files:
            raise FileNotFoundError(
                f"no chunk archives matching {[d.lower() + '*.npy' for d in datasets]} "
                f"under {path} — run the GE2E preprocessing first "
                f"(masg_tpu_torch.preprocessor.ge2e_preprocess; note chunks need "
                f">= tisv_frame*hop samples of voiced audio per VAD span)"
            )
        self.data = {f: np.load(os.path.join(path, f)) for f in self.files}

    @staticmethod
    def decode(filename: str) -> Dict[str, str]:
        d, s, g, l = os.path.basename(filename)[:-4].split("_")
        return {"dataset": d, "spkr": s, "gender": g, "language": l}

    def __len__(self):
        return len(self.files)

    def sample_batch(self, n_speakers: int, variable_length: bool = True,
                     hop: int = 256, sr: int = 22050) -> Tuple[np.ndarray, np.ndarray]:
        """(N*M, T, n_mels) mel chunks + (N*M,) float language labels.
        Language-balanced by idx % n_langs; random crop to a shared variable
        length (reference Collate, data_load.py:114-136)."""
        mels, langs = [], []
        t = self.tisv_frame
        if variable_length:
            lower = int(self.tisv_frame - 0.4 / (hop / sr))
            lower = max(1, min(lower, self.tisv_frame))
            t = self.rng.randint(lower, self.tisv_frame)
        for i in range(n_speakers):
            lang_idx = i % len(self.langs)
            f = self.rng.choice(self.lang2files[self.langs[lang_idx]])
            utters = self.data[f]  # (n_chunks, n_mels, frames)
            idxs = list(range(utters.shape[0]))
            chosen = (
                self.rng.choices(idxs, k=self.m)
                if self.m > len(idxs)
                else self.rng.sample(idxs, self.m)
            )
            sel = utters[chosen][:, :, : self.tisv_frame]
            p = self.rng.randint(0, self.tisv_frame - t)
            sel = sel[:, :, p : p + t]
            mels.append(np.transpose(sel, (0, 2, 1)))  # (M, T, n_mels)
            langs += [float(lang_idx)] * self.m
        return np.concatenate(mels, 0), np.array(langs, np.float32)


def compute_da_threshold(n: int, m: int, n_labels: int = 1) -> float:
    """Reference utils.py:260-264."""
    if n_labels == 1:
        n_labels = 2
    return -math.log(1.0 / n_labels) * n * m


def _adam(params, lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch Adam on its single-tensor path, the math masg_tpu copies."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, foreach=False)


def make_da_optimizer(embedder: SpeechEmbedder) -> torch.optim.Adam:
    """The reference's optimizers['da']: Adam(da_parameters(), 1e-3,
    weight_decay=1e-6), clipped to 3.0 before each step
    (train_speech_embedder.py:104-112,189-191). The per-epoch DA subroutine
    steps the same optimizer (:214), sharing its moments with the main loop."""
    return _adam(embedder.da_parameters(), 1e-3, weight_decay=1e-6)


@dataclass
class GE2ETrainState:
    embedder: SpeechEmbedder
    ge2e: GE2ELossParams
    opt_main: torch.optim.Adam
    opt_ge2e: torch.optim.Adam
    opt_da: torch.optim.Adam


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
        like.device, like.dtype)


def make_ge2e_train_step(
    embedder: SpeechEmbedder,
    n_speakers: int,
    m_utts: int,
    lr: float = 1e-3,
    use_ge2e_backward: bool = True,
    da_threshold: Optional[float] = None,
    mesh: Optional[DataMesh] = None,
) -> Tuple[Callable[..., GE2ETrainState], Callable]:
    """(init_state, step) with the reference's per-group update semantics
    (train_speech_embedder.py:104-112,169-192).

    `init_state(ge2e=None)` builds the three optimizers over `embedder`'s
    parameters and `ge2e` (fresh w = 10, b = -5 when None), on the
    embedder's device and dtype.

    `step(state, mels, langs, pretrain, lr_scale=1.0) -> (state, loss, da)`.
    The DA gate is per batch, from the current loss: `da < threshold or
    pretrain` (:180-182; `pretrain` = progress <= da_startpoint, computed by
    the caller in f64 as the reference does). It scopes three things,
    through torch's set_to_none `zero_grad` (a group left with `None`
    gradients does not step and keeps its moments): (1) whether `da`
    backpropagates at all, (2) the DA group's step and (3), in the ablation
    `use_ge2e_backward=False`, the main group's step too, since `da` is then
    its only gradient. `lr_scale` is the reference's epoch-end halving of the
    main and ge2e learning rates (lr_schedule, :83-94,207); the DA group's lr
    never anneals. The embedder runs in train mode: the head's dropout is live.

    `mesh`: this rank's share of a data-parallel run; `mels` and `langs`
    are then still the GLOBAL batch, of which the step embeds this rank's
    rows, and the returned losses are the global ones.
    """
    mesh = mesh or DataMesh()
    if da_threshold is None:
        da_threshold = compute_da_threshold(n_speakers, m_utts)

    def init_state(ge2e: Optional[GE2ELossParams] = None) -> GE2ETrainState:
        w = next(embedder.parameters())
        ge2e = (ge2e if ge2e is not None else init_ge2e_params()).to(w.device, w.dtype)
        return GE2ETrainState(
            embedder=embedder, ge2e=ge2e,
            opt_main=_adam(embedder.main_parameters(), lr, weight_decay=1e-6),
            opt_ge2e=_adam(ge2e.parameters(), lr),
            opt_da=make_da_optimizer(embedder))

    def step(state: GE2ETrainState, mels, langs, pretrain: bool, lr_scale: float = 1.0):
        net, ge2e = state.embedder, state.ge2e
        w = next(net.parameters())
        for o in (state.opt_main, state.opt_ge2e, state.opt_da):
            o.zero_grad(set_to_none=True)
        net.train()
        rows = mesh.rows(len(mels))
        langs = _as_tensor(langs, w)
        out = net(_as_tensor(mels[rows], w))
        emb = mesh.gather_rows(out["embeddings"]).reshape(n_speakers, m_utts, -1)
        # the GE2E loss of the whole batch and this rank's rows' DA part
        _, loss, da = ge2e_loss(ge2e, emb, out.get("da_lang_logits"), langs[rows])
        da_all = mesh.sum(da.detach())
        gate = bool(da_all < da_threshold) or bool(pretrain)
        if use_ge2e_backward:
            (loss / mesh.parts if mesh.parts > 1 else loss).backward(retain_graph=gate)
        if gate:
            da.backward()
        mesh.reduce_grads([*net.parameters(), *ge2e.parameters()])
        for o in (state.opt_main, state.opt_ge2e):
            for g in o.param_groups:
                g["lr"] = lr * lr_scale
        torch.nn.utils.clip_grad_norm_(net.main_parameters(), 3.0)
        torch.nn.utils.clip_grad_norm_(list(ge2e.parameters()), 1.0)
        state.opt_main.step()
        state.opt_ge2e.step()
        if gate:
            torch.nn.utils.clip_grad_norm_(net.da_parameters(), 3.0)
            state.opt_da.step()
        return state, loss.detach(), da_all

    return init_state, step


def make_da_subroutine_step(mesh: Optional[DataMesh] = None) -> Callable:
    """The DA-head-only step of the reference's da_classifier_subroutine
    (train_speech_embedder.py:249-288): embeddings detached, the head's
    dropout live (train mode), BCE summed, clip 3.0, then the shared
    optimizers['da'] (:214). `step(state, mels, langs) -> loss`; under
    `mesh`, of the global batch (this rank embeds its rows)."""
    mesh = mesh or DataMesh()

    def step(state: GE2ETrainState, mels, langs) -> torch.Tensor:
        net = state.embedder
        w = next(net.parameters())
        state.opt_da.zero_grad(set_to_none=True)
        net.train()
        rows = mesh.rows(len(mels))
        out = net(_as_tensor(mels[rows], w), detach=True)
        loss = bce_with_logits_sum(out["da_lang_logits"], _as_tensor(langs, w)[rows])
        loss.backward()
        mesh.reduce_grads(net.da_parameters())
        torch.nn.utils.clip_grad_norm_(net.da_parameters(), 3.0)
        state.opt_da.step()
        return mesh.sum(loss.detach())

    return step


def run_da_subroutine(state: GE2ETrainState, dataset: SpeakerChunkDataset, n_speakers: int,
                      batches: int = 8, max_epochs: int = 10,
                      verbose: bool = False, mesh: Optional[DataMesh] = None
                      ) -> GE2ETrainState:
    """Retrain the DA head to convergence: stops when an epoch's average loss
    is under 20 or above the previous one, like the reference. Steps the
    train state's own DA optimizer, so its moments carry over both ways."""
    step = make_da_subroutine_step(mesh)
    prev = float("inf")
    for e in range(max_epochs):
        total = 0.0
        for _ in range(batches):
            mels, langs = dataset.sample_batch(n_speakers, variable_length=False)
            total += float(step(state, mels, langs))
        avg = total / batches
        if verbose:
            print(f"Da subroutine epoch {e}, avg loss: {avg:.2f}")
        if avg < 20 or avg > prev:
            break
        prev = avg
    return state


def save_ge2e_checkpoint(path: str, state: GE2ETrainState) -> None:
    """The reference's torch checkpoint, `{"embedder_net": state_dict,
    "ge2e": {"w", "b"}}` (train_speech_embedder.py:218-222), on the CPU: what
    masg_tpu's `load_ge2e_checkpoint` and the port's read."""
    payload = {"embedder_net": {k: v.detach().cpu()
                                for k, v in state.embedder.state_dict().items()},
               "ge2e": {"w": state.ge2e.w.detach().cpu(), "b": state.ge2e.b.detach().cpu()}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader sees a whole file or none


def train_speaker_encoder(
    data_path: str,
    datasets: List[str],
    out_dir: str,
    n_speakers: int = 32,
    m_utts: int = 10,
    epochs: int = 2400,
    batches_per_epoch: Optional[int] = None,
    lr: float = 1e-3,
    da_startpoint: float = 0.0,
    use_ge2e_backward: bool = True,
    anneal_epochs: Tuple[int, ...] = (800, 1400, 1800, 2200),
    checkpoint_interval: int = 200,
    seed: int = 0,
    n_mels: int = 80,
    verbose: bool = True,
    device: DeviceLike = None,
) -> GE2ETrainState:
    """The full trainer (reference train:115-248) on `device` (the card when
    None). Writes `<out_dir>/ckpt_epoch_<e>.pth` every `checkpoint_interval`
    epochs and `<out_dir>/final_epoch_<epochs>.pth` at the end, in the
    reference's torch format (`save_ge2e_checkpoint`). The batches are masg_tpu's
    for the same seed; each step seeds torch's generators from (seed, step)
    for its dropout masks. In a joined process group each rank trains its
    share of every batch (`make_ge2e_train_step`), seeding its masks from
    (seed, step, rank)."""
    from .loop import step_seed

    dev = resolve_device(device)
    ds = SpeakerChunkDataset(data_path, datasets, m_utts=m_utts, seed=seed)
    n_speakers = min(n_speakers, len(ds))
    batches_per_epoch = batches_per_epoch or max(1, len(ds) // n_speakers)
    mesh = DataMesh.from_process_group(n_speakers * m_utts)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        embedder = SpeechEmbedder(n_mels=n_mels)
    embedder.to(dev)
    init_state, step = make_ge2e_train_step(embedder, n_speakers, m_utts, lr,
                                            use_ge2e_backward, mesh=mesh)
    ds.sample_batch(n_speakers, variable_length=False)  # masg_tpu's init batch: same draws
    state = init_state()
    mesh.replicate([*embedder.parameters(), *state.ge2e.parameters()])
    os.makedirs(out_dir, exist_ok=True)

    n_step = 0
    for e in range(epochs):
        progress = e / epochs
        pretrain = progress <= da_startpoint
        lr_scale = 0.5 ** sum(1 for a in anneal_epochs if a < e)
        total = total_da = 0.0
        for _ in range(batches_per_epoch):
            mels, langs = ds.sample_batch(n_speakers, variable_length=False)
            n_step += 1
            torch.manual_seed(step_seed(seed, n_step, mesh.rank))
            state, loss, da = step(state, mels, langs, pretrain, lr_scale)
            total += float(loss)
            total_da += float(da)
        if verbose and mesh.is_lead:
            print(f"Epoch {e+1}: avg ge2e {total/batches_per_epoch:.3f} "
                  f"avg da {total_da/batches_per_epoch:.3f}")
        if progress > da_startpoint:
            # the reference retrains the DA classifier each epoch (:249-288)
            state = run_da_subroutine(state, ds, n_speakers, batches=batches_per_epoch,
                                      mesh=mesh)
        if (e + 1) % checkpoint_interval == 0 and mesh.is_lead:
            save_ge2e_checkpoint(os.path.join(out_dir, f"ckpt_epoch_{e + 1}.pth"), state)
    if mesh.is_lead:
        save_ge2e_checkpoint(os.path.join(out_dir, f"final_epoch_{epochs}.pth"), state)
    mesh.barrier()  # the others return once the checkpoint is whole
    return state


@torch.no_grad()
def evaluate_eer(
    embedder: SpeechEmbedder,
    dataset: SpeakerChunkDataset,
    n_speakers: int = 6,
    m_utts: int = 10,
    epochs: int = 10,
    thresholds=None,
) -> Tuple[float, float]:
    """Speaker-verification equal error rate.

    Reference test() (train_speech_embedder.py:387-460): split each speaker's
    M utterances into enrollment/verification halves, build enrollment
    centroids, sweep thresholds over the cosine-similarity matrix, report the
    threshold where FAR == FRR. Returns (avg_EER, threshold). The embedder
    runs in eval mode (dropout off) and is returned to its mode after.
    """
    assert m_utts % 2 == 0
    if thresholds is None:
        thresholds = [0.01 * i + 0.5 for i in range(50)]
    was_training = embedder.training
    embedder.eval()
    w = next(embedder.parameters())

    total_eer = 0.0
    best_thresh = 0.0  # averaged over epochs alongside the EER
    count = 0
    try:
        for _ in range(epochs):
            mels, _ = dataset.sample_batch(n_speakers, variable_length=False)
            emb = embedder(_as_tensor(mels, w))["embeddings"]
            emb = emb.to(torch.float64 if w.dtype == torch.float64 else torch.float32)
            emb = emb.cpu().numpy()
            emb = emb.reshape(n_speakers, m_utts, -1)
            enroll, verify = emb[:, : m_utts // 2], emb[:, m_utts // 2 :]
            centroids = enroll.mean(axis=1)  # (N, D)
            centroids /= np.linalg.norm(centroids, axis=-1, keepdims=True) + 1e-12
            vn = verify / (np.linalg.norm(verify, axis=-1, keepdims=True) + 1e-12)
            sim = np.einsum("nmd,kd->nmk", vn, centroids)  # (N, M/2, N)

            m_half = m_utts // 2
            best = None
            for thres in thresholds:
                hits = sim > thres
                far = sum(
                    hits[i].sum() - hits[i, :, i].sum() for i in range(n_speakers)
                ) / ((n_speakers - 1) * m_half * n_speakers)
                frr = sum(
                    m_half - hits[i, :, i].sum() for i in range(n_speakers)
                ) / (m_half * n_speakers)
                if best is None or abs(far - frr) < best[0]:
                    best = (abs(far - frr), (far + frr) / 2, thres)
            total_eer += best[1]
            best_thresh += best[2]
            count += 1
    finally:
        embedder.train(was_training)
    return total_eer / max(count, 1), best_thresh / max(count, 1)
