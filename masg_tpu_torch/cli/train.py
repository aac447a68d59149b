"""Training CLI (port of masg_tpu/cli/train.py).

    python -m masg_tpu_torch.cli.train -c <config_dir> [--restore_step N]
        [--checkpoint p] [--use_clf [--clf_featurization model|ge2e]]
        [--corpus A B ...] [--max_steps N] [--seed S] [--bf16]
        [--param_storage f32|bf16|bf16_moments] [--device cuda|cpu] [--no-use_flash]
        [--n_devices N] [--n_model M] [--multihost]

masg_tpu's flags, with `--flash` become `--use_flash/--no-use_flash` (on by
default: attention through kernels K1-K3) and `--device` added (default
`cuda`). `--bf16` is bf16 compute with f32 parameters (torch.autocast);
`--param_storage bf16|bf16_moments` stores the parameters (and Adam's
moments) in bf16 with an f32 master copy, so the model computes in bf16.
`--use_clf` trains against the frozen GE2E discriminator of train.yaml's
`discriminator_path` (a checkpoint of `cli.train_speech_embedder`, or of
the reference, in the reference's torch format), or a random one when none
is set. masg_tpu's mesh flags train over a (data, model) mesh of processes
(`parallel/`): `--n_model M` is the tensor-parallel axis (Megatron-style
shards of the FFT blocks and PostNet, `parallel/mesh.py:PARAM_RULES`),
`--n_devices N` (default M) spawns one process per card (N capped at the
cards present; the data axis is `data_parallel_size(batch_size, N // M)`),
`--multihost` joins the process group the environment names (masg_tpu's
MASG_* names or torchrun's; world size n_data x M) and trains on card
LOCAL_RANK. `--rng_impl` (a TPU generator) has no counterpart.
"""

from __future__ import annotations

import argparse

from ..parallel.mesh import add_parallel_flags, launch_data_parallel


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="experiment config directory")
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="warm-start model weights from another run's ckpt dir")
    parser.add_argument("--use_clf", action="store_true",
                        help="adversarial GE2E language discriminator branch")
    parser.add_argument("--clf_featurization", default="model", choices=["model", "ge2e"],
                        help="--use_clf discriminator input: 'model' = the predicted "
                             "feature mels as they are (the reference's); 'ge2e' = "
                             "mapped into the GE2E encoder's fmin-55 mel basis first")
    parser.add_argument("--corpus", type=str, nargs="*", default=None)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N steps this invocation (smoke runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (autocast), float32 parameters")
    parser.add_argument("--param_storage", default="f32",
                        choices=["f32", "bf16", "bf16_moments"],
                        help="bf16 stores parameters (bf16_moments also Adam's moments) "
                             "in bfloat16 with an f32 master copy")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--use_flash", action=argparse.BooleanOptionalAction, default=True,
                        help="attention through the flash kernels (forward and backward)")
    add_parallel_flags(parser)
    return parser.parse_args(argv)


def main(argv=None):
    from ..core.config import load_config_dir

    args = parse_args(argv)
    cfg = load_config_dir(args.config)
    return launch_data_parallel(run, args, cfg.train.optimizer.batch_size)


def parameter_counts(model) -> str:
    """The parameter count of `model`, and on a model axis the count each
    rank holds."""
    from ..parallel.mesh import sharded_names

    held = sum(p.numel() for p in model.parameters())
    axis = getattr(model, "model_axis", None)
    if axis is None:
        return str(held)
    split = sharded_names(model)
    whole = held + sum(p.numel() for n, p in model.named_parameters()
                       if n in split) * (axis.size - 1)
    return f"{whole} ({held} on each of {axis.size} model ranks)"


def run(args, device):
    """Train on `device` (this process's share when a process group is joined)."""
    from ..core.config import load_config_dir
    from ..train.loop import build_experiment

    trainer = build_experiment(load_config_dir(args.config), corpora=args.corpus,
                               use_clf=args.use_clf, restore_step=args.restore_step,
                               checkpoint=args.checkpoint, seed=args.seed, device=device,
                               use_flash=args.use_flash, bf16=args.bf16,
                               param_storage=args.param_storage,
                               clf_featurization=args.clf_featurization,
                               n_model=args.n_model)
    if trainer.mesh.is_lead:
        print(f"Number of FastSpeech2 Parameters: {parameter_counts(trainer.model)}")
    return trainer.fit(restore_step=args.restore_step, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
