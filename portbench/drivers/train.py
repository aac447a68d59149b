"""The FastSpeech2 train step: the program's `train.step.make_train_step`
(dropout on, the speaker prior's loss, one backward, the clip, Adam with the
Noam schedule from `train.state.create_train_state`), fed as its trainer
feeds it: an in-memory corpus through the program's `data.dataset.Dataset`
padding (text and mel buckets of 16 and 64) and `data.loader.GroupedLoader`
(shuffled, sorted within groups of 4 batches, prefetched on a thread),
each batch moved by `train.step.batch_to_device` inside the window.

Set-up builds one train state and drives it through the stream's first
three steps, which the reference follows; then one step at each padded
shape the window will meet, then the window on the same state.

`correct`: each of the three steps' total loss against the reference's;
the first gradient as the optimizer holds it (Adam's first moment after one
step, / (1 - beta1)) and the parameters' change after three steps, each by
its worst leaf's gap of norms, measured against the larger of that leaf's
and the median leaf's reference norm. Leaves whose reference gradient is
under a thousandth of the median leaf's (a key's bias under softmax) move
by round-off alone and are left out of the change.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import build, traffic, work
from portbench.harness import Check, Context, Outcome, Tracer, seed_int
from portbench.reference import train as ref_train

BUFFERS = ("position_enc", "_bins", "running_mean", "running_var", "num_batches_tracked")
CHECKED_STEPS = 3


def _dataset_class():
    from masg_tpu_torch.data.dataset import Dataset

    class Corpus(Dataset):
        """A corpus made in memory from the seed, padded and batched by the
        program's `Dataset` (features are drawn per utterance on access, as
        a loader reads them). With `shapes_only` its mels have no channels,
        which gives the padded shapes of the stream at no cost."""

        def __init__(self, config: dict, t: dict, seed: int, shapes_only: bool = False):
            pre = config["preprocess"]
            self.batch_size, self.sort, self.drop_last = t["batch_size"], True, True
            self.text_bucket, self.mel_bucket = t["text_bucket"], t["mel_bucket"]
            self.pitch_feature_level = pre["pitch"]["feature"]
            self.energy_feature_level = pre["energy"]["feature"]
            self.speaker_meta_schema = pre["speaker_generation"]["metadata"]
            self.sizes = traffic.corpus_sizes(t, config["model"]["max_seq_len"])
            self.seed, self.config, self.shapes_only = seed, config, shapes_only
            self.n_mels = pre["mel"]["n_mel_channels"]
            self.gender, self.lang = build.speakers(config)
            # mel targets are windows of one bank of frames drawn from the
            # seed, so that an item costs the loader what a read does
            self.bank = (None if shapes_only else traffic.rng(seed, 8).standard_normal(
                (t["mel_bank_frames"], self.n_mels), dtype=np.float32))

        def __len__(self):
            return len(self.sizes)

        def item(self, g: np.random.Generator, d: np.ndarray, name: str) -> dict:
            n, frames = len(d), int(d.sum())
            if self.shapes_only:
                z = np.zeros(n, np.int64)
                return {"id": name, "speaker": 0, "speaker_name": "spk0", "text": z,
                        "speaker_meta": {"gender": "M", "language": "ja"}, "raw_text": "",
                        "mel": np.zeros((frames, 0), np.float32), "pitch": z, "energy": z,
                        "duration": d, "accent": z}
            spk = int(g.integers(0, len(self.gender)))
            ids, acc = traffic.utterance(g, n, self.config["n_symbols"], self.lang[spk] == 0)
            at = int(g.integers(0, len(self.bank) - frames + 1))
            mel = self.bank[at:at + frames]
            return {"id": name, "speaker": spk, "speaker_name": f"spk{spk}",
                    "speaker_meta": {"gender": "MF"[self.gender[spk]],
                                     "language": ("ja", "en")[self.lang[spk]]},
                    "text": ids, "raw_text": "", "mel": mel,
                    "pitch": g.standard_normal(n).astype(np.float32),
                    "energy": g.standard_normal(n).astype(np.float32),
                    "duration": d, "accent": acc}

        def __getitem__(self, idx: int) -> dict:
            g = None if self.shapes_only else traffic.rng(self.seed, 5, idx)
            return self.item(g, self.sizes[idx], str(idx))

    return Corpus


def _stream(ds, t: dict, seed: int):
    from masg_tpu_torch.data.loader import GroupedLoader

    loader = GroupedLoader(ds, batch_size=t["batch_size"], group_size=t["group_size"],
                           seed=seed, drop_last=False)
    while True:
        for group in loader:
            yield from group


def _shape(batch) -> tuple:
    return batch["texts"].shape[1], batch["mels"].shape[1]


def warm_batch(ds, shape, max_frames: int) -> dict:
    """A batch of `shape` (padded phones, padded frames) from the corpus's
    own item maker: every row at the padded sizes."""
    n, t = shape
    frames = min(t, max_frames)
    d = np.full(n, frames // n, np.int64)
    d[:frames % n] += 1
    g = traffic.rng(0, 6)
    items = [ds.item(g, d, f"warm{i}") for i in range(ds.batch_size)]
    return ds.reprocess(items, list(range(ds.batch_size)))


def _to_tensors(batch: dict, device: str) -> Dict[str, torch.Tensor]:
    ints = ("speakers", "texts", "src_lens", "mel_lens", "durations", "accents")
    return {k: torch.as_tensor(np.asarray(v), device=device,
                               dtype=torch.long if k in ints else torch.float32)
            for k, v in batch.items() if k not in ("ids", "raw_texts")}


def run(ctx: Context) -> Outcome:
    from masg_tpu_torch.core.config import OptimizerConfig
    from masg_tpu_torch.ops.attention import flash_attention, flash_attention_dkv, flash_attention_dq
    from masg_tpu_torch.train import step as step_mod
    from masg_tpu_torch.train.state import create_train_state

    config, t, dev = ctx.config, ctx.cell["traffic"], ctx.device
    model_cfg, opt = config["model"], config["optimizer"]
    max_frames = model_cfg["max_seq_len"]
    ctx.stamp("imported")
    fs2_sd, _ = build.weights(config, ctx.seed, dev, vocoder=False)
    ctx.stamp("weights")
    model = build.port_fs2(config, fs2_sd, dev)
    ctx.stamp("model")
    state = create_train_state(model, OptimizerConfig(
        batch_size=t["batch_size"], betas=tuple(opt["betas"]), eps=opt["eps"],
        weight_decay=opt["weight_decay"], grad_clip_thresh=opt["grad_clip_thresh"],
        warm_up_step=opt["warm_up_step"], anneal_steps=tuple(opt["anneal_steps"]),
        anneal_rate=opt["anneal_rate"]), model_cfg["transformer"]["encoder_hidden"])
    train_step = step_mod.make_train_step(model)
    Corpus = _dataset_class()
    ds = Corpus(config, t, ctx.seed)
    stream = _stream(ds, t, ctx.seed)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    n_step = 0
    ctx.stamp("built")

    def one(batch):
        nonlocal n_step
        with ctx.span("to_device"):
            db = step_mod.batch_to_device(batch, dev, torch.float32)
        with ctx.span("step"):
            _, m = train_step(state, db, seed_int(ctx.seed, n_step))
        n_step += 1
        return m

    # the steps the reference follows, through the window's own call and feed
    first = [next(stream) for _ in range(CHECKED_STEPS)]
    prog = {"loss": [], "grad": {}, "change": {}}
    for i, batch in enumerate(first):
        m = one(batch)
        prog["loss"].append(float(m.total - m.speaker_prior))  # the objective
        if i == 0:
            b1 = opt["betas"][0]
            moments = [state.optimizer.state.get(p, {}).get("exp_avg") for p in state.params()]
            prog["grad"] = {n: 0.0 if m is None else float(torch.linalg.vector_norm(m)) / (1 - b1)
                            for n, m in zip(names, moments)}
    with torch.no_grad():
        prog["change"] = {n: float(torch.linalg.vector_norm(p - fs2_sd[n]))
                          for n, p in zip(names, state.params())}
    ctx.stamp("first_steps")

    # one step at each padded shape of the stream's first `warm_batches`
    seen = {_shape(b) for b in first}
    peek = _stream(Corpus(config, t, ctx.seed, shapes_only=True), t, ctx.seed)
    todo = []
    for _ in range(t["warm_batches"]):
        s = _shape(next(peek))
        if s not in seen:
            seen.add(s)
            todo.append(s)
    ctx.stamp("shapes")
    for s in todo:
        one(warm_batch(ds, s, max_frames))
    ctx.rec.counters["shapes"] = len(seen)
    n0 = {k: f.launches for k, f in (("K1", flash_attention), ("K2", flash_attention_dq),
                                      ("K3", flash_attention_dkv))}
    frames, steps = 0, []
    sync = torch.cuda.synchronize if dev.startswith("cuda") else (lambda: None)
    sync()
    with Tracer(ctx.trace) as tracer:
        ctx.window_opens()
        tracer.mark()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            with ctx.span("loader"):
                batch = next(stream)
            one(batch)
            frames += int(batch["mel_lens"].sum())
            steps.append((batch["src_lens"], batch["mel_lens"], _shape(batch)))
        sync()  # the steps queued on the device end inside the window
        window_s = time.perf_counter() - t0
    ctx.window_closed()
    rec = ctx.rec
    rec.window_s = window_s
    if ctx.trace:
        rec.events, rec.trace_window = tracer.kernels(), (tracer.t0, tracer.t1)
    rec.counters.update(steps=len(steps), unwarmed=sum(s[2] not in seen for s in steps),
                        **{k: f.launches - n0[k] for k, f in (
                            ("K1", flash_attention), ("K2", flash_attention_dq),
                            ("K3", flash_attention_dkv))})
    tr = model_cfg["transformer"]
    heads, dh = tr["encoder_head"], tr["encoder_hidden"] // tr["encoder_head"]
    launches: List[tuple] = []
    flops = 0
    n_mels = config["preprocess"]["mel"]["n_mel_channels"]
    for src, mel, (lp, tp) in steps:
        tm = min(tp, max_frames)
        mel = np.minimum(mel, tm)
        fwd = ([work.flash_work(src, lp, heads, dh, 4)] * tr["encoder_layer"]
               + [work.flash_work(mel, tm, heads, dh, 4)] * tr["decoder_layer"])
        bwd = ([work.flash_bwd_work(src, lp, heads, dh, 4)] * tr["encoder_layer"]
               + [work.flash_bwd_work(mel, tm, heads, dh, 4)] * tr["decoder_layer"])
        launches += fwd + [k2 for k2, _ in bwd] + [k3 for _, k3 in bwd]
        flops += sum(3 * work.fs2_forward_flops(model_cfg, n_mels, int(s), int(m))
                     for s, m in zip(src, mel))
    rec.work.update(k1k3_launches=launches, useful_flops=flops)
    del state, model, train_step
    checks = compare(config, fs2_sd, first, [seed_int(ctx.seed, i) for i in range(3)], prog,
                     dev, ctx.cell["limits"], rec.counters)
    return Outcome(e2e={"train_frames_per_s": frames / window_s}, attempted=len(steps),
                   failed=0, checks=checks)


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's gap of norms, against the larger of its own and the median
    leaf's reference norm."""
    med = float(np.median([ref[k] for k in ref]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def reference_readings(config: dict, sd, batches: List[dict], seeds: List[int], device: str):
    """The reference's losses, first-gradient leaf norms and change norms."""
    params = {k: v for k, v in sd.items() if not k.endswith(BUFFERS)}
    buffers = {k: v for k, v in sd.items() if k.endswith(BUFFERS)}
    traj = ref_train.Trajectory(params, config["model"], config["optimizer"])
    losses = [float(traj.step(_to_tensors(b, device), s, buffers).total.detach())
              for b, s in zip(batches, seeds)]
    grad = {k: float(torch.linalg.vector_norm(g)) for k, g in traj.grads[0].items()}
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(traj.params[k] - params[k])) for k in params}
    return losses, grad, change


def compare(config: dict, sd, batches, seeds, prog: dict, device: str, limits: dict,
            where: Optional[dict] = None) -> List[Check]:
    """The checks: the worst step's loss gap, the median leaf's gap of first
    gradient norms (the worst leaf's swings from seed to seed with the
    cancellation in a few attention projections' gradients; `where`, when
    given, gets it and its leaf), the worst moving leaf's gap of changes."""
    losses, grad, change = reference_readings(config, sd, batches, seeds, device)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], losses))
    med = float(np.median(list(grad.values())))
    moved = [k for k in grad if grad[k] >= 1e-3 * med]
    g = _gaps(prog["grad"], grad, grad)
    c = _gaps(prog["change"], {k: change[k] for k in moved}, moved)
    if where is not None:
        worst = max(g, key=g.get)
        where.update(grad_gap_worst=g[worst], grad_gap_worst_leaf=worst,
                     change_gap_leaf=max(c, key=c.get))
    return [Check("loss_rel", loss_rel, limits["loss_rel"]),
            Check("grad_norm_gap", float(np.median(list(g.values()))), limits["grad_norm_gap"]),
            Check("change_norm_gap", max(c.values()), limits["change_norm_gap"])]
