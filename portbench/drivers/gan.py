"""HiFi-GAN's adversarial training step: the program's
`train.vocoder.make_vocoder_train_step` over the state of
`init_vocoder_train_state`, fed as `cli.train_vocoder.run` feeds it: wav
files on disk through `data.vocoder.VocoderSegmentDataset(normalize=True)`
(random crops of `segment_size` samples, per-file peak normalisation,
shuffled epochs), each batch moved by the program's
`train.vocoder.batch_to_device` (`torch.from_numpy(batch).to(device)` under
its span `data.to_device`; that line itself where the program lacks the
helper) inside the window.

Set-up writes a corpus of 16-bit wavs made from the seed to a temporary
directory, builds the train state and takes `warm_steps` steps. At the
window's opening it captures the state (every parameter, AdamW's moments
and step counts, the power iteration's u). The window runs at least
`checked_steps` steps. After its first it holds on to each parameter's
gradient (the program leaves a step's gradients on the parameters until
the next step drops them, so holding them copies nothing); after the last
checked one it takes one copy of each parameter's change since the opening
(one pass over the parameters, its host and device time kept as the
counters `capture_host_ms` and `capture_device_ms`) and of the u vectors.
The norms of both are taken after the window closes.

`correct`: after the window, the program's state freed, the reference
(`reference/hifigan_gan.py`) follows the same batches from the captured
state: `loss_rel`, the larger gap of d_loss and g_loss at the first checked
step (the later steps' gaps, kept as `loss_gaps` beside the checks, carry
AdamW's amplification of round-off: see PERF.md); `grad_norm_gap`,
the median leaf's gap of the first step's gradient norms (generator and
discriminator leaves both); `change_norm_gap`, the worst moving leaf's gap
of the change after the checked steps (leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone);
`sn_u_gap`, the largest distance between the program's and the
reference's unit vectors u. A leaf's gap is measured against the larger
of its own and the median leaf's reference norm.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
import wave
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import traffic, work_gan
from portbench.harness import Check, Context, Outcome, Tracer, seed_int
from portbench.program_spans import program_counters
from portbench.reference import hifigan_gan as ref_gan

# the program's parametrized names -> upstream's
_UPSTREAM = ((".parametrizations.weight.original0", ".weight_g"),
             (".parametrizations.weight.original1", ".weight_v"),
             (".parametrizations.weight.original", ".weight_orig"),
             (".parametrizations.weight.0._u", ".weight_u"))


def upstream_name(name: str) -> str:
    for a, b in _UPSTREAM:
        if name.endswith(a):
            return name[:-len(a)] + b
    return name


def program_config(config: dict) -> dict:
    """The program's training config: its defaults (V1 and
    `cli.train_vocoder.DEFAULT_TRAIN_CONFIG`), then config_v1 and the
    discriminators' sizes from the configuration."""
    from masg_tpu_torch.cli.train_vocoder import DEFAULT_TRAIN_CONFIG
    from masg_tpu_torch.infer.vocoder import DEFAULT_HIFIGAN_CONFIG

    d = config["discriminators"]
    return {**DEFAULT_HIFIGAN_CONFIG, **DEFAULT_TRAIN_CONFIG, **config["hifigan"],
            "mpd_periods": d["periods"], "mpd_channels": d["period_channels"],
            "msd_scales": d["scales"], "msd_layers": d["scale_layers"]}


# --- the corpus --------------------------------------------------------------------


def utterance(g: np.random.Generator, n: int, sr: int, t: dict) -> np.ndarray:
    """n samples of speech-like audio: voiced stretches (a smoothed sawtooth,
    whose harmonics fall as 1/k, on an F0 drifting inside `f0_hz`, with a
    little breath noise) parted by noise bursts or near-silence."""
    out = np.zeros(n, np.float32)
    lo, hi = t["f0_hz"]
    pos = int(g.uniform(*t["gap_s"]) * sr)
    while pos < n:
        m = min(int(g.uniform(*t["voiced_s"]) * sr), n - pos)
        anchors = g.uniform(lo, hi, max(2, m // (sr // 10) + 2))
        f0 = np.interp(np.arange(m), np.linspace(0, m, len(anchors)), anchors)
        phase = np.cumsum(f0 / sr)
        saw = 2.0 * (phase - np.floor(phase)) - 1.0
        saw = np.convolve(saw, [0.25, 0.5, 0.25])[1:m + 1]
        env = np.minimum(1.0, np.minimum(np.arange(m), np.arange(m)[::-1]) / (0.02 * sr))
        out[pos:pos + m] = env * (g.uniform(0.3, 1.0) * saw + 0.02 * g.standard_normal(m))
        pos += m
        k = min(int(g.uniform(*t["gap_s"]) * sr), max(0, n - pos))
        if g.random() < 0.5:  # an unvoiced burst: differenced noise
            out[pos:pos + k] = g.uniform(0.05, 0.3) * np.diff(g.standard_normal(k + 1))
        else:
            out[pos:pos + k] = 1e-3 * g.standard_normal(k)
        pos += k
    return out


def write_corpus(seed: int, t: dict, sr: int, root: str) -> List[str]:
    """`corpus_size` 16-bit wavs under `root`: the same lengths for every
    seed (the law's stratified quantiles, in an order drawn from the seed),
    contents and levels from the seed."""
    law = t["seconds"]
    secs = np.clip(np.exp(np.log(law["median"]) + law["sigma"]
                          * traffic.stratified_normal(t["corpus_size"])), law["min"], law["max"])
    g = traffic.rng(seed, 21)
    paths = []
    for i, s in enumerate(g.permutation(secs)):
        x = utterance(g, int(round(s * sr)), sr, t)
        x *= g.uniform(0.1, 0.9) / max(float(np.abs(x).max()), 1e-9)
        path = os.path.join(root, f"utt{i:04d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(np.round(x * 32767).astype("<i2").tobytes())
        paths.append(path)
    return paths


# --- the program's state, read ----------------------------------------------------------


def leaves(state) -> Dict[str, torch.nn.Parameter]:
    """Every parameter of the train state under upstream's names, prefixed
    `generator.`, `mpd.` and `msd.`."""
    return {f"{part}.{upstream_name(n)}": p for part in ("generator", "mpd", "msd")
            for n, p in getattr(state, part).named_parameters()}


def sn_u(state) -> Dict[str, torch.Tensor]:
    """The power iteration's u of each spectral-normed conv (its v is
    computed from u at the next iteration)."""
    return {f"msd.{upstream_name(n)}": b for n, b in state.msd.named_buffers()
            if n.endswith("._u")}


@dataclass
class Opening:
    """The state at the window's opening: parameters (on the device),
    AdamW's (exp_avg, exp_avg_sq, step) of each (on the host; zeros and 0
    for a parameter its optimizer has not stepped), the updates the state
    has taken (the schedule's count), the power iteration's u vectors."""

    params: Dict[str, torch.Tensor]
    moments: Dict[str, Tuple[torch.Tensor, torch.Tensor, int]]
    count: int
    sn_u: Dict[str, torch.Tensor]


def capture(state) -> Opening:
    params = leaves(state)
    held = {**state.gen_opt.state, **state.disc_opt.state}
    moments = {}
    for k, p in params.items():
        s = held.get(p, {})
        if "exp_avg" in s:
            moments[k] = (s["exp_avg"].detach().to("cpu", copy=True),
                          s["exp_avg_sq"].detach().to("cpu", copy=True), int(s["step"]))
        else:
            zero = torch.zeros(p.shape, dtype=p.dtype)
            moments[k] = (zero, zero, 0)
    return Opening({k: p.detach().clone() for k, p in params.items()}, moments, state.step,
                   {k: b.detach().clone() for k, b in sn_u(state).items()})


@dataclass
class Readings:
    """What a checked stretch of steps gave: (d_loss, g_loss) a step, the
    first step's gradient norm and the change's norm by leaf, the u vectors
    after the last step."""

    loss: List[Tuple[float, float]] = field(default_factory=list)
    grad: Dict[str, float] = field(default_factory=dict)
    change: Dict[str, float] = field(default_factory=dict)
    u: Dict[str, torch.Tensor] = field(default_factory=dict)


def _norms(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    return list(torch._foreach_norm(tensors)) if tensors else []


def reference_readings(config: dict, opening: Opening, ys: List[torch.Tensor],
                       steps_per_epoch: int, device: str, allow_tf32: bool = False) -> Readings:
    """The reference's readings over batches `ys` from the opening state."""
    dev = lambda t: t.to(device)
    params = {k: dev(v) for k, v in opening.params.items()}
    traj = ref_gan.Trajectory(
        params, {k: dev(v) for k, v in opening.sn_u.items()},
        {k: (dev(m), dev(v), n) for k, (m, v, n) in opening.moments.items()}, opening.count, config,
        steps_per_epoch, allow_tf32=allow_tf32)
    out = Readings()
    for y in ys:
        d, g = traj.step(y)
        out.loss.append((float(d), float(g)))
    names = list(params)
    out.grad = dict(zip(names, (float(n) for n in _norms([traj.grads[0][k] for k in names]))))
    with torch.no_grad():
        out.change = {k: float(torch.linalg.vector_norm(traj.params[k] - params[k]))
                      for k in names}
    out.u = {k: v.clone() for k, v in traj.sn_u.items()}
    return out


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    med = float(np.median(list(ref.values())))
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in keys}


def compare(prog: Readings, ref: Readings, limits: dict,
            where: Optional[dict] = None) -> List[Check]:
    """The four checks; `where`, when given, gets the worst leaves."""
    loss_gaps = [[abs(a - b) / abs(b) for a, b in zip(pa, ra)]
                 for pa, ra in zip(prog.loss, ref.loss)]
    loss_rel = max(loss_gaps[0])
    med = float(np.median(list(ref.grad.values())))
    moved = [k for k in ref.grad if ref.grad[k] >= 1e-3 * med]
    g = _gaps(prog.grad, ref.grad, ref.grad)
    c = _gaps(prog.change, {k: ref.change[k] for k in moved}, moved)
    u = {k: float(torch.linalg.vector_norm(prog.u[k].to(v.device) - v)) for k, v in ref.u.items()}
    if where is not None:
        worst = max(g, key=g.get)
        where.update(loss_gaps=loss_gaps, grad_gap_worst=g[worst], grad_gap_worst_leaf=worst,
                     change_gap_leaf=max(c, key=c.get), sn_u_leaf=max(u, key=u.get))
    return [Check("loss_rel", loss_rel, limits["loss_rel"]),
            Check("grad_norm_gap", float(np.median(list(g.values()))), limits["grad_norm_gap"]),
            Check("change_norm_gap", max(c.values()), limits["change_norm_gap"]),
            Check("sn_u_gap", max(u.values()), limits["sn_u_gap"])]


# --- the run ---------------------------------------------------------------------------


@dataclass
class Setup:
    cfg: dict
    state: object
    step_fn: object
    batches: object
    steps_per_epoch: int
    to_device: object


def prepare(ctx: Context, root: str) -> Setup:
    """The corpus (written under `root`), the dataset's stream, the train
    state and its step, and the warm-up steps: everything before the window
    opens."""
    from masg_tpu_torch.data.vocoder import VocoderSegmentDataset, list_wavs
    from masg_tpu_torch.train import vocoder as tv

    t, dev = ctx.cell["traffic"], ctx.device
    cfg = program_config(ctx.config)
    ctx.stamp("imported")
    write_corpus(ctx.seed, t, int(cfg["sampling_rate"]), root)
    ctx.stamp("corpus")
    ds = VocoderSegmentDataset(list_wavs(root), segment_size=int(cfg["segment_size"]),
                               sample_rate=int(cfg["sampling_rate"]), seed=seed_int(ctx.seed, 22),
                               normalize=True)
    spe = ds.steps_per_epoch(t["batch_size"])
    state = tv.init_vocoder_train_state(cfg, spe, seed=seed_int(ctx.seed, 23), device=dev)
    ctx.stamp("built")
    to_device = getattr(tv, "batch_to_device", None) or (lambda b, d: torch.from_numpy(b).to(d))
    s = Setup(cfg, state, tv.make_vocoder_train_step(cfg), ds.batches(t["batch_size"]), spe,
              to_device)
    for _ in range(t["warm_steps"]):
        one(s, ctx)
    if dev.startswith("cuda"):
        torch.cuda.synchronize()
        # the program's own peak, before the benchmark's copies of the state
        ctx.rec.counters["warm_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    ctx.stamp("warm")
    return s


def one(s: Setup, ctx: Context):
    """One step as the trainer takes it: the next batch, moved, stepped."""
    with ctx.span("to_device"):
        y = s.to_device(next(s.batches), ctx.device)
    with ctx.span("step"):
        _, m = s.step_fn(s.state, y)
    return y, m


def run(ctx: Context) -> Outcome:
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage

    t, dev = ctx.cell["traffic"], ctx.device
    n_checked = t["checked_steps"]
    root = tempfile.mkdtemp(prefix="portbench_gan_")
    try:
        s = prepare(ctx, root)
        opening = capture(s.state)
        params = leaves(s.state)
        names = list(params)
        ctx.stamp("captured")
        k4 = fused_mrf_stage.launches
        ys, losses, grads, change, u = [], [], [], [], {}
        steps = 0
        cuda = dev.startswith("cuda")
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else []
        with Tracer(ctx.trace) as tracer:
            ctx.window_opens()
            tracer.mark()
            t0 = time.perf_counter()
            while steps < n_checked or time.perf_counter() - t0 < ctx.seconds:
                y, m = one(s, ctx)
                steps += 1
                if steps <= n_checked:
                    ys.append(y)
                    losses.append(m)
                    if steps == 1:
                        grads = [(k, params[k].grad) for k in names
                                 if params[k].grad is not None]
                    if steps == n_checked:
                        c0 = time.perf_counter()
                        for e in events[:1]:
                            e.record()
                        with torch.no_grad():
                            change = torch._foreach_sub([params[k].detach() for k in names],
                                                        [opening.params[k] for k in names])
                        u = {k: b.clone() for k, b in sn_u(s.state).items()}
                        for e in events[1:]:
                            e.record()
                        capture_host_ms = 1e3 * (time.perf_counter() - c0)
            sync()  # the steps queued on the device end inside the window
            window_s = time.perf_counter() - t0
        ctx.window_closed()
        rec = ctx.rec
        rec.window_s = window_s
        if ctx.trace:
            rec.events, rec.trace_window = tracer.kernels(), (tracer.t0, tracer.t1)
            rec.counters.update({f"program.{k}": v
                                 for k, v in (program_counters(rec) or {}).items()})
        hop = int(s.cfg["hop_size"])
        frames = steps * t["batch_size"] * int(s.cfg["segment_size"]) // hop
        rec.counters.update(steps=steps, K4=fused_mrf_stage.launches - k4,
                            steps_per_epoch=s.steps_per_epoch, capture_host_ms=capture_host_ms)
        if events:
            rec.counters["capture_device_ms"] = events[0].elapsed_time(events[1])
        rec.work["useful_flops"] = steps * work_gan.step_flops(ctx.config, t["batch_size"])
        grad_norms = _norms([g for _, g in grads])
        prog = Readings(loss=[(float(m.disc_loss), float(m.gen_loss)) for m in losses],
                        grad={k: float(n) for (k, _), n in zip(grads, grad_norms)},
                        change={k: float(n) for k, n in zip(names, _norms(change))}, u=u)
        spe = s.steps_per_epoch
        del s, params, losses, grads, grad_norms, change
        gc.collect()
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()
        ref = reference_readings(ctx.config, opening, ys, spe, dev)
        checks = compare(prog, ref, ctx.cell["limits"], rec.counters)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return Outcome(e2e={"train_frames_per_s": frames / window_s}, attempted=steps, failed=0,
                   checks=checks)
