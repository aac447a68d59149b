"""Training loop + evaluation (port of masg_tpu/train/loop.py).

Reference control flow (train.py:30-293): an epoch-less loop over the
grouped loader; per real batch one train step (train/step.py); periodic
log / synth / val / save; a hard stop at total_step.

Resume is deterministic: the loader's shuffle is a pure function of
(seed, epoch), a restored run skips `restore_step % batches_per_epoch`
batches of its epoch, and each step seeds torch's generators from
(seed, step), so a resumed run sees the same batches and draws the same
dropout masks as the run it continues. SIGTERM/SIGINT finish the step in
flight, save, and return.

`build_experiment` composes the three FastSpeech2 trainers of masg_tpu
(train/loop.py:575-652): plain, `--use_clf` (a frozen GE2E discriminator,
`load_ge2e_checkpoint`) and ganlike (FastSpeech2 and the discriminator under
one optimizer, `models/ganlike.py`), each with `param_storage`, and each with
the JDIT teacher when the config sets `jdit.use_jdit` (its loss joins the
plain and `--use_clf` steps, as in masg_tpu; ganlike's step leaves it out).

The (data, model) mesh (masg_tpu's device mesh): one process per device,
joined in a torch.distributed group (`parallel/`). Every rank builds the
same loader from the same seed and takes its data rank's rows of each
global batch (`DataMesh.shard_batch`); the step sums the data ranks'
gradients, so every rank takes the one-device update of its parameters. On
a model axis (`n_model` > 1) each rank holds its shard of the split weights
(`FastSpeech2.from_config(mesh=)`). Parameters and buffers are broadcast
from data rank 0 at start and after a restore. The model group of data
rank 0 evaluates, synthesizes samples and gathers checkpoints together (all
three run collectives over it); rank 0 alone logs and writes the files (in
the one layout of `core/checkpoint.py`, whatever the topology), and the
other ranks meet it at a barrier. Each rank seeds its dropout from (seed,
step, data rank), so the model ranks of a data rank draw the same masks.

masg_tpu's `_pack_batch`/`_unpack_fn` (one host->device transfer per batch,
a workaround for a remoted TPU) has no counterpart here.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.config import ExperimentConfig
from ..data.dataset import ConcatDataset, Dataset
from ..data.loader import GroupedLoader
from ..device import DeviceLike, resolve_device
from ..models.fastspeech2 import FastSpeech2
from ..models.ganlike import GANLike
from ..models.speaker_encoder import SpeechEmbedder
from ..parallel.mesh import DataMesh
from ..utils.logging import Logger, log_losses
from .optim import noam_schedule
from .state import TrainState, create_train_state
from .step import (batch_to_device, draw_shuffle, make_eval_step, make_ganlike_train_step,
                   make_train_step)


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The dropout seed of `step`: a pure function of (seed, step), the
    counterpart of masg_tpu's `fold_in(rng, step)`; a data rank > 0 of a
    data-parallel run seeds its rows' masks from (seed, step, rank)."""
    return int(np.random.SeedSequence([seed, step] + ([rank] if rank else []))
               .generate_state(1)[0])


class Trainer:
    def __init__(self, cfg: ExperimentConfig, state: TrainState,
                 train_loader: GroupedLoader, val_dataset: Optional[Dataset] = None,
                 seed: int = 0, autocast_dtype: Optional[torch.dtype] = None,
                 use_clf: bool = False, discriminator: Optional[SpeechEmbedder] = None,
                 clf_featurization: str = "model", mesh: Optional[DataMesh] = None):
        self.cfg = cfg
        self.mesh = mesh or DataMesh()
        self.model = model = state.fs2  # the FastSpeech2 (ganlike: state.model's half)
        self.state = state
        self.discriminator = discriminator  # kept for introspection, as in masg_tpu
        self.train_loader = train_loader
        self.val_dataset = val_dataset
        self.seed = seed
        self.device = next(model.parameters()).device
        self.float_dtype = next(model.parameters()).dtype

        t = cfg.train
        self.total_step = t.step.total_step
        self.log_step = t.step.log_step
        self.synth_step = t.step.synth_step
        self.val_step = t.step.val_step
        self.save_step = t.step.save_step

        levels = dict(pitch_feature_level=cfg.preprocess.pitch.feature,
                      energy_feature_level=cfg.preprocess.energy.feature,
                      use_speaker_prior=cfg.model.multi_speaker,
                      autocast_dtype=autocast_dtype)
        adversarial = dict(lambd=t.lambda_, total_step=self.total_step)
        # the speaker shuffle (and ganlike's label jitter), drawn on the host
        self._shuffle = use_clf or state.discriminator is not None
        if state.discriminator is not None:  # ganlike
            self.train_step_fn = make_ganlike_train_step(state.model, **adversarial, **levels)
        else:
            self.train_step_fn = make_train_step(
                model, use_clf=use_clf, use_jdit=cfg.model.jdit.use_jdit,
                discriminator=discriminator, clf_featurization=clf_featurization,
                **adversarial, **levels)
        self.eval_step_fn = make_eval_step(model, **levels)

        self.ckpt = CheckpointManager(t.path.ckpt_path, max_to_keep=t.step.keep_last)
        # host mirror of the schedule for LR telemetry: update n uses lr_fn(n)
        self._lr_fn = noam_schedule(cfg.model.transformer.encoder_hidden,
                                    t.optimizer.warm_up_step, t.optimizer.anneal_steps,
                                    t.optimizer.anneal_rate)
        self.train_logger = self.val_logger = None
        if self.mesh.is_lead:
            self.train_logger = Logger(os.path.join(t.path.log_path, "train"))
            self.val_logger = Logger(os.path.join(t.path.log_path, "val"))

    def _place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return batch_to_device(batch, self.device, self.float_dtype)

    def _train_batch(self, batch: Dict[str, np.ndarray], step: int
                     ) -> Tuple[Dict[str, torch.Tensor], int, DataMesh]:
        """(this rank's rows of the host batch on the device, the dropout
        seed of this rank's step, the mesh of this batch): the train step's
        arguments after the state."""
        if self._shuffle:
            batch = draw_shuffle(batch, step_seed(self.seed, step),
                                 jitter=self.state.discriminator is not None,
                                 max_frames=self.model.decoder.max_seq_len)
        mesh = self.mesh.for_batch(len(batch["speakers"]))
        # a replicated batch is the one-device step on every rank: rank 0's masks
        seed = step_seed(self.seed, step, mesh.rank if mesh.parts > 1 else 0)
        return self._place_batch(mesh.shard_batch(batch)), seed, mesh

    # ------------------------------------------------------------------
    def fit(self, restore_step: int = 0, max_steps: Optional[int] = None,
            verbose: bool = True) -> TrainState:
        step = restore_step + 1
        stop_at = min(self.total_step,
                      (restore_step + max_steps) if max_steps else self.total_step)
        log_path = os.path.join(self.cfg.train.path.log_path, "train")
        if self.mesh.is_lead:
            os.makedirs(log_path, exist_ok=True)

        # position the data stream where the original run was at restore_step
        skip = 0
        bpe = self.train_loader.batches_per_epoch
        if restore_step and bpe:
            self.train_loader.epoch = restore_step // bpe
            skip = restore_step % bpe

        # SIGTERM/SIGINT set a flag; the loop finishes the step in flight,
        # saves at the CURRENT step and returns (`--restore_step <step>` resumes)
        preempted = {"flag": False}
        prev_handlers = {}

        def _on_signal(signum, frame):
            preempted["flag"] = True

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[s] = signal.signal(s, _on_signal)
        except ValueError:
            pass  # not the main thread

        try:
            return self._fit_loop(step, stop_at, log_path, time.time(), verbose,
                                  preempted, skip)
        finally:
            for s, h in prev_handlers.items():
                signal.signal(s, h)

    def _fit_loop(self, step, stop_at, log_path, t_start, verbose, preempted, skip=0):
        k = self.state.grad_acc_step
        lead = self.mesh.is_lead
        done = False
        while not done:
            for group in self.train_loader:
                for batch in group:
                    if skip > 0:  # fast-forwarding to the restore position
                        skip -= 1
                        continue
                    self.state, metrics = self.train_step_fn(self.state,
                                                             *self._train_batch(batch, step))

                    if step % self.log_step == 0 and lead:
                        losses = [float(x) for x in (metrics.total, metrics.mel,
                                                     metrics.postnet_mel, metrics.pitch,
                                                     metrics.energy, metrics.duration)]
                        log_losses(self.train_logger, step, losses,
                                   eloss=float(metrics.speaker_prior),
                                   dloss=float(metrics.dloss))
                        self.train_logger.add_scalar("Training/learning_rate",
                                                     self._lr_fn((step - 1) // k), step)
                        msg1 = f"Step {step}/{self.total_step}, "
                        msg2 = (
                            "Total Loss: {:.4f}, Mel Loss: {:.4f}, Mel PostNet Loss: {:.4f}, "
                            "Pitch Loss: {:.4f}, Energy Loss: {:.4f}, Duration Loss: {:.4f}"
                        ).format(*losses)
                        with open(os.path.join(log_path, "log.txt"), "a") as f:
                            f.write(msg1 + msg2 + "\n")
                        if verbose:
                            rate = step / max(time.time() - t_start, 1e-9)
                            print(msg1 + msg2 + f" [{rate:.1f} steps/s]")

                    synth = step % self.synth_step == 0
                    val = step % self.val_step == 0 and self.val_dataset is not None
                    saved = step % self.save_step == 0
                    # data rank 0's model group: its forwards and gathers are
                    # collectives over that group
                    row = self.mesh.lead_row
                    if synth and row:
                        self.synth_sample(batch, step)

                    if val and row:
                        self.evaluate(step)

                    if saved and row:
                        self.ckpt.save(step, self.state)

                    if self.mesh.any(preempted["flag"]):
                        if not saved and row:
                            self.ckpt.save(step, self.state)
                        if lead:
                            print(f"preempted: checkpoint saved at step {step}; "
                                  f"resume with --restore_step {step}")
                        done = True
                    if synth or val or saved or done:
                        self.mesh.barrier()  # the others wait for rank 0's work
                    if done:
                        break

                    if step >= stop_at:
                        done = True
                        break
                    step += 1
                if done:
                    break
        return self.state

    # ------------------------------------------------------------------
    def synth_sample(self, batch: Dict[str, np.ndarray], step: int,
                     logger: Optional[Logger] = None, tag_prefix: str = "Training") -> None:
        """Reference synth_step hook (train.py:225-260, utils/tools.py
        synth_one_sample): prediction-vs-GT mel figures with pitch/energy
        overlays for the first batch item. The eval forward runs on every
        rank of data rank 0's model group; rank 0 then draws the figure,
        best-effort (a failure there is printed, not raised)."""
        _, _, out = self.eval_step_fn(self.state, self._place_batch(batch))
        if not self.mesh.is_lead:
            return
        try:
            self._plot_sample(batch, out, step, logger or self.train_logger, tag_prefix)
        except Exception as e:  # telemetry: the run goes on
            print(f"{tag_prefix} synth sample failed: {e}")

    def _plot_sample(self, batch, out, step, logger, tag_prefix) -> None:
        from ..utils.logging import plot_mel

        i = 0
        mel_len = int(out.mel_len[i])
        src_len = int(out.src_len[i])
        if mel_len == 0:
            return
        mel_pred = out.postnet_mel[i, :mel_len].float().cpu().numpy()
        mel_gt = np.asarray(batch["mels"])[i, :mel_len]
        duration = np.asarray(batch["durations"])[i, :src_len]
        # phoneme-level targets expand by duration; frame-level are per frame
        # (reference utils/tools.py:181-190)
        if self.cfg.preprocess.pitch.feature == "phoneme_level":
            pitch = np.repeat(np.asarray(batch["pitches"])[i, :src_len], duration)[:mel_len]
        else:
            pitch = np.asarray(batch["pitches"])[i, :mel_len]
        if self.cfg.preprocess.energy.feature == "phoneme_level":
            energy = np.repeat(np.asarray(batch["energies"])[i, :src_len], duration)[:mel_len]
        else:
            energy = np.asarray(batch["energies"])[i, :mel_len]
        stats = (list(self.cfg.stats.pitch) + list(self.cfg.stats.energy[:2])
                 if self.cfg.stats is not None else [-1, 1, 0, 1, -1, 1])
        fig = plot_mel([(mel_pred.T, pitch, energy), (mel_gt.T, pitch, energy)], stats,
                       ["Synthetized Spectrogram", "Ground-Truth Spectrogram"])
        logger.add_figure(f"{tag_prefix}/step_{step}_{batch['ids'][i]}", fig, step)
        import matplotlib.pyplot as plt

        plt.close(fig)

    # ------------------------------------------------------------------
    def evaluate(self, step: int) -> List[float]:
        """Dataset-size-weighted mean losses over the validation split
        (reference evaluate.py:18-75)."""
        loader = GroupedLoader(self.val_dataset, batch_size=self.train_loader.batch_size,
                               group_size=1, shuffle=False)
        sums = None
        eloss_sum = 0.0
        count = 0
        last_batch = None
        for group in loader:
            for batch in group:
                n = len(batch["ids"])
                losses, eloss, _ = self.eval_step_fn(self.state, self._place_batch(batch))
                losses = [float(x) for x in losses]
                if sums is None:
                    sums = [0.0] * len(losses)
                sums = [s + v * n for s, v in zip(sums, losses)]
                eloss_sum += float(eloss) * n
                count += n
                last_batch = batch
        means = [s / max(count, 1) for s in sums] if sums else []
        if means and self.mesh.is_lead:
            log_losses(self.val_logger, step, means, eloss=eloss_sum / max(count, 1))
            msg = ("Validation Step {}, Total Loss: {:.4f}, Mel Loss: {:.4f}, "
                   "Mel PostNet Loss: {:.4f}, Pitch Loss: {:.4f}, Energy Loss: {:.4f}, "
                   "Duration Loss: {:.4f}").format(step, *means)
            val_log = os.path.join(self.cfg.train.path.log_path, "val")
            os.makedirs(val_log, exist_ok=True)
            with open(os.path.join(val_log, "log.txt"), "a") as f:
                f.write(msg + "\n")
        # one synthesized val sample per evaluation (reference evaluate.py:83-111)
        if last_batch is not None:
            self.synth_sample(last_batch, step, logger=self.val_logger, tag_prefix="Validation")
        return means


# ----------------------------------------------------------------------
def build_corpus_dict(cfg: ExperimentConfig, name: str) -> dict:
    """Per-corpus preprocess dict in the Dataset constructor's schema
    (the raw-yaml shape the reference passes around, train.py:38-44)."""
    cc = cfg.corpora[name]
    return {
        "dataset": cc.dataset,
        "path": {"raw_path": cc.raw_path, "preprocessed_path": cc.preprocessed_path},
        "preprocessing": {
            "val_size": cfg.preprocess.val_size,
            "test_size": cfg.preprocess.test_size,
            "audio": {"sampling_rate": cfg.preprocess.audio.sampling_rate,
                      "max_wav_value": cfg.preprocess.audio.max_wav_value},
            "stft": vars(cfg.preprocess.stft),
            "mel": {"n_mel_channels": cfg.preprocess.mel.n_mel_channels,
                    "mel_fmin": cfg.preprocess.mel.mel_fmin,
                    "mel_fmax": cfg.preprocess.mel.mel_fmax},
            "pitch": vars(cfg.preprocess.pitch),
            "energy": vars(cfg.preprocess.energy),
            "speaker_generation": {"metadata": cfg.preprocess.speaker_generation.metadata},
        },
        "text": {"text_cleaners": cc.text_cleaners, "language": cc.language},
        "accent": {"use_accent": cc.use_accent},
    }


def load_ge2e_checkpoint(path: str, n_mels: int = 80) -> SpeechEmbedder:
    """A GE2E speaker encoder from the reference's torch checkpoint
    (`{"embedder_net": state_dict, ...}`, train_speech_embedder.py:218-222,
    or a bare state_dict), as `train/ge2e.py` writes it and masg_tpu's
    `load_ge2e_checkpoint` (train/loop.py:655-675) reads it. Its widths
    (hidden, projection, LSTM layers) come from the checkpoint, as masg_tpu
    takes them (:612-618). Returns the embedder in f32 on the CPU.

    masg_tpu's orbax directories are not read here: the port reads the torch
    format (write one with masg_tpu's `compat/torch_fs2.export_torch_ge2e`)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (masg_tpu's orbax GE2E checkpoint); masg_tpu_torch "
            f"reads the reference's torch format, a file holding {{'embedder_net': "
            f"state_dict}} (train/ge2e.py writes it)")
    if not os.path.exists(path):
        raise FileNotFoundError(f"GE2E checkpoint does not exist: {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("embedder_net", ckpt)
    n_layers = sum(1 for k in sd if k.startswith("LSTM_stack.weight_ih_l"))
    hidden = int(sd["LSTM_stack.weight_hh_l0"].shape[1])
    proj = int(sd["projection.linear_layer.weight"].shape[0])
    use_da = any(k.startswith("da_classifier.") for k in sd)
    embedder = SpeechEmbedder(n_mels=n_mels, hidden=hidden, n_layers=n_layers, proj=proj,
                              use_da=use_da)
    embedder.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return embedder


def _discriminator(cfg: ExperimentConfig, seed: int) -> SpeechEmbedder:
    """The GE2E language discriminator: from `discriminator_path` when the
    config names one (it must exist, reference train.py:74-91), else a
    random init seeded from seed + 1, with model.yaml's discriminator.hidden
    (masg_tpu train/loop.py:597-624)."""
    n_mels = cfg.preprocess.mel.n_mel_channels
    dpath = cfg.train.discriminator_path
    if dpath:
        if not os.path.exists(dpath):
            raise FileNotFoundError(f"train.yaml discriminator_path does not exist: {dpath}")
        return load_ge2e_checkpoint(dpath, n_mels)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        return SpeechEmbedder(n_mels=n_mels, hidden=cfg.model.discriminator.hidden)


def build_experiment(cfg: ExperimentConfig, corpora: Optional[List[str]] = None,
                     use_clf: bool = False, ganlike: bool = False, restore_step: int = 0,
                     checkpoint: Optional[str] = None, seed: int = 0,
                     device: DeviceLike = None, use_flash: bool = True,
                     bf16: bool = False, val_split: str = "val.txt",
                     param_storage: str = "f32", clf_featurization: str = "model",
                     n_model: int = 1, mesh: Optional[DataMesh] = None) -> Trainer:
    """Datasets + model + optimizer + Trainer from a config dir (the CLI
    composition root; reference train.py:30-105), on `device` (the card when
    None). `bf16` runs forward and loss under bf16 autocast with f32
    parameters, masg_tpu's `--bf16`. `param_storage` "bf16" / "bf16_moments"
    stores FastSpeech2's parameters in bf16 (so it computes in bf16) with an
    f32 master copy in the optimizer (and bf16 Adam moments). `use_clf`
    trains against a frozen GE2E discriminator, `ganlike` jointly with it
    (`clf_featurization`: see `make_train_step`). `checkpoint`, another run's
    checkpoint dir, warm-starts the FastSpeech2 weights only from its latest
    step. `mesh`: this process's place in a parallel run (default: the
    joined process group's (world / n_model, n_model) mesh, one device
    without one); on its model axis the FastSpeech2's split weights hold
    this rank's shard. Every topology starts from the one-device weights of
    `seed` and reads and writes the same checkpoints."""
    corpora = corpora or list(cfg.corpora)
    if not corpora:
        raise ValueError("no corpora configured (preprocess_<CORPUS>.yaml in the config dir)")
    dev = resolve_device(device)

    bs = cfg.train.optimizer.batch_size
    mesh = mesh or DataMesh.from_process_group(bs, n_model)
    # padded lengths round up to 16 text / 64 mel frames, the buckets of
    # masg_tpu's batches, so both packages train on the same padded shapes
    buckets = dict(text_bucket=16, mel_bucket=64)
    train_sets = [Dataset("train.txt", build_corpus_dict(cfg, c), batch_size=bs, sort=True,
                          drop_last=True, **buckets)
                  for c in corpora]
    # the reference's evaluate.py reads val.txt (evaluate.py:32-33);
    # val_split="test.txt" evaluates the held-out split
    val_sets = [Dataset(val_split, build_corpus_dict(cfg, c), batch_size=bs, sort=False,
                        drop_last=False, **buckets)
                for c in corpora]
    if len(train_sets) > 1:
        train_ds = ConcatDataset(cfg.config_dir, train_sets)
        val_ds = ConcatDataset(cfg.config_dir, val_sets)
    else:
        train_ds, val_ds = train_sets[0], val_sets[0]
    loader = GroupedLoader(train_ds, batch_size=bs, group_size=cfg.train.group_size,
                           seed=seed, drop_last=False)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FastSpeech2.from_config(cfg, use_flash=use_flash, mesh=mesh)
    model.to(dev)
    if param_storage != "f32":
        model.to(torch.bfloat16)  # PostNet's BatchNorm statistics stay f32
    discriminator = _discriminator(cfg, seed).to(dev) if (use_clf or ganlike) else None
    trained = GANLike(model, discriminator) if ganlike else model
    state = create_train_state(trained, cfg.train.optimizer,
                               cfg.model.transformer.encoder_hidden, param_storage)
    trainer = Trainer(cfg, state, loader, val_dataset=val_ds, seed=seed,
                      autocast_dtype=torch.bfloat16 if bf16 else None, use_clf=use_clf,
                      discriminator=discriminator, clf_featurization=clf_featurization,
                      mesh=mesh)

    if checkpoint is not None:
        other = CheckpointManager(checkpoint)
        trainer.state = other.restore_model_only(other.latest_step(), trainer.state)
    if restore_step:
        trainer.state = trainer.ckpt.restore(restore_step, trainer.state)
    st = trainer.state  # every data rank starts from data rank 0's weights
    mesh.replicate([*st.model.parameters(), *st.model.buffers(), *(st.master or [])])
    return trainer
