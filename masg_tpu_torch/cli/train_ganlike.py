"""Adversarial (ganlike) training CLI (port of masg_tpu/cli/train_ganlike.py).

    python -m masg_tpu_torch.cli.train_ganlike -c <config_dir> [--restore_step N]
        [--checkpoint p] [--corpus A B ...] [--max_steps N] [--seed S] [--bf16]
        [--device cuda|cpu] [--no-use_flash] [--n_devices N] [--n_model M] [--multihost]

The reference's `python train_ganlike.py -c <config_dir>` (train_ganlike.py:
268-315): FastSpeech2 and the GE2E language discriminator (train.yaml's
`discriminator_path`, or a random one) train jointly under one optimizer
against jittered language labels. Checkpoints hold
`{"model", "discriminator", "optimizer"}`. The flags are `cli.train`'s,
the mesh ones included (`--n_model M` splits the FastSpeech2; the
discriminator is replicated).
"""

from __future__ import annotations

import argparse

from ..parallel.mesh import add_parallel_flags, launch_data_parallel


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="warm-start FastSpeech2 weights from another run's ckpt dir")
    parser.add_argument("--corpus", type=str, nargs="*", default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (autocast), float32 parameters")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--use_flash", action=argparse.BooleanOptionalAction, default=True,
                        help="attention through the flash kernels (forward and backward)")
    add_parallel_flags(parser)
    args = parser.parse_args(argv)

    from ..core.config import load_config_dir

    cfg = load_config_dir(args.config)
    return launch_data_parallel(run, args, cfg.train.optimizer.batch_size)


def run(args, device):
    """Train on `device` (this process's share when a process group is joined)."""
    from ..core.config import load_config_dir
    from ..train.loop import build_experiment
    from .train import parameter_counts

    trainer = build_experiment(load_config_dir(args.config), corpora=args.corpus,
                               ganlike=True, restore_step=args.restore_step,
                               checkpoint=args.checkpoint, seed=args.seed, device=device,
                               use_flash=args.use_flash, bf16=args.bf16,
                               n_model=args.n_model)
    if trainer.mesh.is_lead:
        print(f"Number of GANLike Parameters: {parameter_counts(trainer.state.model)}")
    return trainer.fit(restore_step=args.restore_step, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
