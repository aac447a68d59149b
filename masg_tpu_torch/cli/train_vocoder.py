"""HiFi-GAN vocoder training CLI (port of masg_tpu/cli/train_vocoder.py).

    python -m masg_tpu_torch.cli.train_vocoder --wav_dir raw_data/JSUT \\
        --out out/vocoder [--config hifigan/config.json] [--steps 100000]
        [--mel_dir out/predicted_mel] [--warm_start_generator g.pth.tar]
        [--warm_start_discriminators do_02500000]
        [--restore out/vocoder/vocoder_5000.pth.tar] [--device cuda|cpu]
        [--n_devices N] [--multihost]

masg_tpu's flags plus `--device` (default `cuda`) and
`--warm_start_discriminators` (upstream's `do_*` file, for fine-tuning a
released vocoder with its discriminators, as upstream does). Without
`--config` (and without `hifigan/config.json` at the repository root) it
trains the universal V1 generator on the reference config.json's audio settings
(22,050 Hz, hop 256, n_fft 1024, fmax 8000, the full band for the loss mel),
segment 8192, batch 16, lr 2e-4, betas (0.8, 0.99), lr_decay 0.999.

Checkpoints are torch files: `vocoder_{step}.pth.tar` holds the whole GAN
state and the data stream's position (its RNG state, the epoch's order and
the next item), and `--restore` resumes from it where the stream stopped, at
the same cost at any step (masg_tpu restarts the stream);
`generator_{step}.pth.tar` is `{"generator": state_dict}` with weight norm
folded, the upstream format, which `infer.vocoder.get_vocoder(checkpoint=)`
and masg_tpu's `load_generator_checkpoint` read. `log.jsonl` gets masg_tpu's lines.
`--n_devices N` trains data-parallel as masg_tpu does (its mesh over the
batch): `data_parallel_size(batch_size, N)` processes, each on its rows of
every batch (all of them draw the same stream), averaging the gradients;
rank 0 logs and writes the checkpoints. `--multihost` joins the group the
environment names (see `cli.train`). masg_tpu trains the vocoder with no
model axis (n_model=1), so `--n_model` > 1 raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..parallel.mesh import add_parallel_flags, launch_data_parallel

# the reference hifigan/config.json (universal V1) and masg_tpu's training defaults
DEFAULT_TRAIN_CONFIG = {
    "segment_size": 8192, "learning_rate": 2e-4, "adam_b1": 0.8, "adam_b2": 0.99,
    "lr_decay": 0.999, "batch_size": 16, "seed": 1234, "num_mels": 80, "n_fft": 1024,
    "hop_size": 256, "win_size": 1024, "sampling_rate": 22050, "fmin": 0, "fmax": 8000,
    "fmax_for_loss": None,
}


def save_torch(path: str, payload) -> None:
    import torch

    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader sees a whole file or none


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav_dir", type=str, required=True,
                        help="directory tree of training wavs")
    parser.add_argument("--mel_dir", type=str, default=None,
                        help="fine-tuning mode (upstream --fine_tuning): generator inputs "
                             "come from .npy mels here (e.g. cli.dump_mels output), paired "
                             "with wav_dir audio by basename")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--config", type=str, default=None,
                        help="hifigan config.json (reference schema); defaults to the "
                             "universal V1 hyperparameters")
    parser.add_argument("--steps", type=int, default=100000)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="override config batch_size")
    parser.add_argument("--restore", type=str, default=None,
                        help="vocoder_{step}.pth.tar to resume from")
    parser.add_argument("--warm_start_generator", type=str, default=None,
                        help="torch or msgpack generator checkpoint to initialize G from "
                             "(fine-tune mode)")
    parser.add_argument("--warm_start_discriminators", type=str, default=None,
                        help="upstream do_* checkpoint whose mpd and msd state dicts "
                             "initialize the discriminators (fine-tune mode)")
    parser.add_argument("--save_step", type=int, default=5000)
    parser.add_argument("--log_step", type=int, default=100)
    parser.add_argument("--no_normalize", action="store_true",
                        help="train on raw wav amplitudes instead of the upstream per-file "
                             "0.95-peak normalization (from-scratch mode only; fine-tuning "
                             "never normalizes, matching upstream)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    add_parallel_flags(parser)
    args = parser.parse_args(argv)
    cfg = training_config(args.config)
    return launch_data_parallel(run, args, args.batch_size or int(cfg["batch_size"]),
                                model_axis=False)


def training_config(path=None) -> dict:
    """The HiFi-GAN training config: V1 and the defaults above, then the
    file at `path` (or `hifigan/config.json` at the repository root)."""
    from ..infer.vocoder import DEFAULT_HIFIGAN_CONFIG

    cfg = {**DEFAULT_HIFIGAN_CONFIG, **DEFAULT_TRAIN_CONFIG}
    default_cfg = os.path.join(os.path.dirname(__file__), "..", "..", "hifigan", "config.json")
    cfg_path = path or (default_cfg if os.path.exists(default_cfg) else None)
    if cfg_path:
        with open(cfg_path) as f:
            cfg.update(json.load(f))
    return cfg


def run(args, device):
    """Train on `device` (this process's share when a process group is joined)."""
    import numpy as np
    import torch

    from ..data.vocoder import VocoderFineTuneDataset, VocoderSegmentDataset, list_wavs
    from ..device import resolve_device
    from ..infer.vocoder import load_generator_checkpoint
    from ..parallel.mesh import DataMesh
    from ..train.vocoder import (batch_to_device, export_generator_state_dict,
                                 init_vocoder_train_state, load_upstream_discriminators,
                                 make_vocoder_train_step)

    device = resolve_device(device)
    cfg = training_config(args.config)
    batch_size = args.batch_size or int(cfg["batch_size"])
    seed = args.seed if args.seed is not None else int(cfg.get("seed", 1234))
    mesh = DataMesh.from_process_group(batch_size)
    lead = mesh.is_lead

    if args.mel_dir:
        dataset = VocoderFineTuneDataset(
            args.mel_dir, args.wav_dir, segment_size=int(cfg["segment_size"]),
            hop_size=int(cfg["hop_size"]), sample_rate=int(cfg["sampling_rate"]), seed=seed)
        if lead:
            print(f"{len(dataset.pairs)} (mel, wav) fine-tuning pairs")
    else:
        paths = list_wavs(args.wav_dir)
        if lead:
            print(f"{len(paths)} training wavs under {args.wav_dir}")
        dataset = VocoderSegmentDataset(
            paths, segment_size=int(cfg["segment_size"]),
            sample_rate=int(cfg["sampling_rate"]), seed=seed,
            normalize=not args.no_normalize)
    steps_per_epoch = dataset.steps_per_epoch(batch_size)

    gen_sd = (load_generator_checkpoint(args.warm_start_generator, cfg)
              if args.warm_start_generator else None)
    state = init_vocoder_train_state(cfg, steps_per_epoch, seed=seed, gen_state_dict=gen_sd,
                                     device=device)
    if args.warm_start_discriminators:
        do = torch.load(args.warm_start_discriminators, map_location="cpu", weights_only=True)
        load_upstream_discriminators(state, do["mpd"], do["msd"])
    if args.restore:
        payload = torch.load(args.restore, map_location="cpu", weights_only=True)
        state.load_state_dict(payload)
        dataset.load_stream_state(payload["data_stream"])
        if lead:
            print(f"restored {args.restore} at step {state.step}")
    mesh.replicate([*state.generator.state_dict().values(), *state.mpd.state_dict().values(),
                    *state.msd.state_dict().values()])
    step_fn = make_vocoder_train_step(cfg, from_mels=bool(args.mel_dir), mesh=mesh)
    rows = mesh.rows(batch_size)

    os.makedirs(args.out, exist_ok=True)
    start = state.step
    batches = dataset.batches(batch_size, num_steps=max(0, args.steps - start))
    t0 = time.time()
    log_path = os.path.join(args.out, "log.jsonl")
    for batch in batches:
        if args.mel_dir:  # this rank's rows
            batch = tuple(np.asarray(x)[rows] for x in batch)
        else:
            batch = batch[rows]
        state, metrics = step_fn(state, batch_to_device(batch, device))
        step = state.step
        if not lead:
            continue
        if step % args.log_step == 0 or step == start + 1:
            rate = (step - start) / max(1e-9, time.time() - t0)
            line = {"step": step, "disc_loss": float(metrics.disc_loss),
                    "gen_loss": float(metrics.gen_loss), "mel_l1": float(metrics.mel_l1),
                    "fm": float(metrics.fm), "steps_per_s": round(rate, 3)}
            print(json.dumps(line), flush=True)
            with open(log_path, "a") as f:
                f.write(json.dumps(line) + "\n")
        if step % args.save_step == 0 or step >= args.steps:
            save_torch(os.path.join(args.out, f"vocoder_{step}.pth.tar"),
                       {**state.state_dict(), "data_stream": dataset.stream_state()})
            save_torch(os.path.join(args.out, f"generator_{step}.pth.tar"),
                       {"generator": export_generator_state_dict(state.generator)})
    mesh.barrier()  # the others return once rank 0's checkpoints are whole
    if lead:
        print(f"done at step {state.step}; checkpoints in {args.out}")
    return state


if __name__ == "__main__":
    main()
