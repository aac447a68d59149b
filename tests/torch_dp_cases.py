"""Jobs of the port's data-parallel tests, and the pool of gloo ranks on the
CPU that runs them (tests/test_torch_port_parallel.py).

Every job is `job(rank, world, *args)`, runs the same on every rank of the
pool (world 2) and in the test process alone (world 1, no process group:
the one-device reference), and returns host data only (numpy, floats), so
results travel by value. The pool keeps its processes and their process
group for a test module's jobs; each job has its own timeout, and a rank
that raises or does not answer in time fails the job. torch and
masg_tpu_torch only: a spawned rank imports this module by name.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.parallel import distributed as D
from masg_tpu_torch.parallel.mesh import DataMesh

METRICS = ("total", "mel", "postnet_mel", "pitch", "energy", "duration", "speaker_prior",
           "dloss", "grad_norm")
HIDDEN = 64
JDIT_DIMS = dict(attention_rnn_dim=32, decoder_rnn_dim=24, prenet_hidden=16,
                 attention_dim=16, location_filters=8, location_kernel=5)
DISC = dict(hidden=32, n_layers=2, proj=16)


def _serve(rank, world, port, jobs, results, timeout_s):
    torch.set_num_threads(1)
    D.initialize(f"localhost:{port}", world, rank, backend="gloo", device=torch.device("cpu"),
                 timeout_s=timeout_s)
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            fn, args = job
            try:
                results.put((rank, "ok", fn(rank, world, *args)))
            except BaseException:  # reported to the test, which fails the job
                results.put((rank, "error", traceback.format_exc()))
    finally:
        D.shutdown()


class RankPool:
    """`world` spawned processes in one gloo group, serving jobs until closed."""

    def __init__(self, world: int = 2, timeout_s: float = 60.0):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.jobs = [ctx.SimpleQueue() for _ in range(world)]
        self.results = ctx.SimpleQueue()
        port = D.free_port()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, port, self.jobs[r], self.results, timeout_s))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout_s: float = 60.0):
        """Every rank's `fn(rank, world, *args)`, in rank order."""
        for q in self.jobs:
            q.put((fn, args))
        out, deadline = {}, time.monotonic() + timeout_s
        while len(out) < self.world:
            if not self.results.empty():
                r, status, value = self.results.get()
                if status != "ok":
                    raise RuntimeError(f"rank {r} of {fn.__name__} failed:\n{value}")
                out[r] = value
                continue
            dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
            if dead:
                raise RuntimeError(f"{fn.__name__}: ranks {dead} died")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: no answer from every rank in {timeout_s} s")
            time.sleep(0.02)
        return [out[r] for r in range(self.world)]

    def close(self):
        for q, p in zip(self.jobs, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def _mesh(rank, world):
    return DataMesh(world, rank) if world > 1 else None


def _np_state(module: torch.nn.Module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def tiny_config(use_jdit: bool = False, grad_acc_step: int = 1):
    """The port's copy of tests/test_torch_port_train.py's tiny_config."""
    cfg = tcfg.ExperimentConfig(
        preprocess=tcfg.PreprocessConfig(), model=tcfg.ModelConfig(), train=tcfg.TrainConfig(),
        stats=tcfg.Stats(pitch=(-3.0, 3.0, 0.0, 1.0), energy=(-3.0, 3.0, 0.0, 1.0)),
        speakers={f"spk{i}": [i, "MF"[i % 2], "ja" if i < 2 else "en"] for i in range(4)})
    tr = cfg.model.transformer
    tr.encoder_layer = tr.decoder_layer = 2
    tr.encoder_hidden = tr.decoder_hidden = HIDDEN
    tr.conv_filter_size = 128
    cfg.model.variance_predictor.filter_size = 64
    opt = cfg.train.optimizer
    opt.warm_up_step, opt.grad_acc_step = 10, grad_acc_step
    opt.betas, opt.eps, opt.weight_decay, opt.grad_clip_thresh = (0.9, 0.98), 1e-6, 0.0, 1.0
    if use_jdit:
        cfg.model.jdit.use_jdit = True
        for k, v in JDIT_DIMS.items():
            setattr(cfg.model.jdit, k, v)
    return cfg


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    if getattr(model, "jdit", None) is not None:
        dec = model.jdit.decoder
        dec.prenet.p = dec.p_attention_dropout = dec.p_decoder_dropout = 0.0
    return model


def fs2_steps(rank, world, variant, init_sd, disc_sd, batches, grad_acc_step=1):
    """`len(batches)` f64 train steps of `variant` ("plain", "use_clf",
    "ganlike", "jdit"), dropout off, from `init_sd` (and the discriminator's
    `disc_sd`): (StepMetrics per step, the final state_dict of the trained
    module)."""
    from masg_tpu_torch.models import FastSpeech2
    from masg_tpu_torch.models.ganlike import GANLike
    from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
    from masg_tpu_torch.train.state import create_train_state
    from masg_tpu_torch.train.step import (batch_to_device, make_ganlike_train_step,
                                           make_train_step)

    cfg = tiny_config(use_jdit=variant == "jdit", grad_acc_step=grad_acc_step)
    model = FastSpeech2.from_config(cfg, use_flash=False).to(torch.float64)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init_sd.items()}, strict=True)
    no_dropout(model)
    disc = None
    if disc_sd is not None:
        disc = SpeechEmbedder(n_mels=80, **DISC).to(torch.float64)
        disc.load_state_dict({k: torch.from_numpy(v) for k, v in disc_sd.items()})
    if variant == "ganlike":
        trained = GANLike(model, disc)
        step = make_ganlike_train_step(trained, total_step=100)
    else:
        trained = model
        step = make_train_step(model, use_clf=variant == "use_clf", use_jdit=variant == "jdit",
                               discriminator=disc, total_step=100)
    state = create_train_state(trained, cfg.train.optimizer, HIDDEN)
    mesh = DataMesh(world, rank)
    traj = []
    for b in batches:
        m = mesh.for_batch(len(b["speakers"]))
        local = batch_to_device(m.shard_batch(b), "cpu", torch.float64)
        state, metrics = step(state, local, 0, m if world > 1 else None)
        traj.append({k: float(getattr(metrics, k)) for k in METRICS})
    return traj, _np_state(trained)


def batchnorm(rank, world, x, cot):
    """TorchBatchNorm in train mode over the global (B, T, C) batch `x`:
    (this rank's output rows, the gradient of sum(out * cot) for its input
    rows, the weight and bias gradients summed over the ranks, the running
    statistics)."""
    from masg_tpu_torch.models.postnet import TorchBatchNorm

    torch.manual_seed(0)
    bn = TorchBatchNorm(x.shape[-1], eps=1e-5).to(torch.float64).train()
    with torch.no_grad():
        bn.weight.normal_()
        bn.bias.normal_()
    mesh = DataMesh(world, rank).for_batch(len(x))
    rows = mesh.rows(len(x))
    xr = torch.from_numpy(x[rows]).requires_grad_(True)
    out = bn(xr, mesh if world > 1 else None)
    (out * torch.from_numpy(cot[rows])).sum().backward()
    mesh.reduce_grads(bn.parameters())
    return (out.detach().numpy(), xr.grad.numpy(), bn.weight.grad.numpy(),
            bn.bias.grad.numpy(), bn.running_mean.numpy(), bn.running_var.numpy())


def ge2e_steps(rank, world, init_sd, batches, n_speakers, m_utts):
    """f64 GE2E train steps, the head's dropout off, from `init_sd`: the
    (ge2e, da) losses per step, a DA-subroutine loss, and the final weights."""
    from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
    from masg_tpu_torch.train.ge2e import make_da_subroutine_step, make_ge2e_train_step

    net = SpeechEmbedder(n_mels=80, **DISC).to(torch.float64)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in init_sd.items()})
    no_dropout(net)
    mesh = _mesh(rank, world)
    init_state, step = make_ge2e_train_step(net, n_speakers, m_utts, lr=1e-3, mesh=mesh)
    state = init_state()
    losses = []
    for i, (mels, langs) in enumerate(batches):
        state, loss, da = step(state, mels, langs, pretrain=i == 0)
        losses.append((float(loss), float(da)))
    sub = float(make_da_subroutine_step(mesh)(state, *batches[0]))
    weights = _np_state(net)
    weights.update(w=state.ge2e.w.detach().numpy(), b=state.ge2e.b.detach().numpy())
    return losses, sub, weights


VOCODER_CFG = {"segment_size": 2048, "num_mels": 80, "upsample_rates": [8, 8, 4],
               "upsample_kernel_sizes": [16, 16, 8], "upsample_initial_channel": 16,
               "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
               "mpd_periods": [2], "mpd_channels": [4, 8, 8, 8], "msd_scales": 2,
               "msd_layers": [[8, 15, 1, 1], [16, 41, 4, 4], [16, 5, 1, 1]]}


def vocoder_steps(rank, world, audio_batches):
    """f64 HiFi-GAN GAN steps at a tiny width on this rank's rows of each
    (B, segment) batch: VocoderMetrics per step and the final weights."""
    from masg_tpu_torch.cli.train_vocoder import training_config
    from masg_tpu_torch.train.vocoder import init_vocoder_train_state, make_vocoder_train_step

    cfg = {**training_config(), **VOCODER_CFG}
    state = init_vocoder_train_state(cfg, steps_per_epoch=100, seed=3, dtype=torch.float64)
    mesh = DataMesh(world, rank).for_batch(len(audio_batches[0]))
    step = make_vocoder_train_step(cfg, mesh=mesh if world > 1 else None)
    traj = []
    for y in audio_batches:
        state, m = step(state, torch.from_numpy(y[mesh.rows(len(y))]))
        traj.append([float(x) for x in m])
    weights = {f"{n}.{k}": v for n in ("generator", "mpd", "msd")
               for k, v in _np_state(getattr(state, n)).items()}
    return traj, weights


def _train_without_postnet_dropout(args, device):
    """cli.train's `run` with PostNet's fixed dropout off (the config sets
    every other dropout), so that runs over 1 and 2 ranks take one step.
    tensorboard logs through its own stub instead of TensorFlow, whose
    import costs a spawned rank ~14 s."""
    import sys

    sys.modules.setdefault("tensorflow", None)
    from masg_tpu_torch.cli import train as train_cli
    from masg_tpu_torch.models import postnet

    init = postnet.PostNet.__init__

    def without_dropout(self, *a, **kw):
        init(self, *a, **kw)
        self.dropout.p = 0.0

    postnet.PostNet.__init__ = without_dropout
    try:
        train_cli.run(args, device)
    finally:
        postnet.PostNet.__init__ = init


def train_cli(argv, n_devices):
    """`cli.train` over `n_devices` CPU processes through the launcher
    `cli.train` calls (`launch_data_parallel`), PostNet's dropout off."""
    from masg_tpu_torch.cli import train as train_cli
    from masg_tpu_torch.core.config import load_config_dir
    from masg_tpu_torch.parallel.mesh import launch_data_parallel

    args = train_cli.parse_args([*argv, "--device", "cpu", "--n_devices", str(n_devices)])
    bs = load_config_dir(args.config).train.optimizer.batch_size
    launch_data_parallel(_train_without_postnet_dropout, args, bs)


def losses_logged(log_dir: str):
    """{step: {tag: value}} of the losses a run logged (its train logger's
    scalars.jsonl, at full precision)."""
    import json
    import os

    out = {}
    with open(os.path.join(log_dir, "train", "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["tag"].startswith("Loss/"):
                out.setdefault(r["step"], {})[r["tag"]] = r["value"]
    return out


def as_batch(b):
    """A host batch's float fields in f64 (the jobs train in f64)."""
    return {k: (np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f" else v)
            for k, v in b.items()}
