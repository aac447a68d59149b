"""Training CLI (port of masg_tpu/cli/train.py).

    python -m masg_tpu_torch.cli.train -c <config_dir> [--restore_step N]
        [--checkpoint p] [--corpus A B ...] [--max_steps N] [--seed S]
        [--bf16] [--device cuda|cpu] [--no-use_flash]

masg_tpu's flags, with `--flash` become `--use_flash/--no-use_flash` (on by
default: attention through kernels K1-K3) and `--device` added (default
`cuda`). `--bf16` is bf16 compute with f32 parameters (torch.autocast).
`--use_clf` is not ported yet and raises. masg_tpu's `--param_storage`,
mesh flags (`--n_devices`, `--n_model`, `--multihost`), `--rng_impl` and
`--clf_featurization` are not offered (ROADMAP.md).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="experiment config directory")
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="warm-start model weights from another run's ckpt dir")
    parser.add_argument("--use_clf", action="store_true",
                        help="adversarial GE2E language discriminator (not ported yet)")
    parser.add_argument("--corpus", type=str, nargs="*", default=None)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N steps this invocation (smoke runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (autocast), float32 parameters")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--use_flash", action=argparse.BooleanOptionalAction, default=True,
                        help="attention through the flash kernels (forward and backward)")
    args = parser.parse_args(argv)

    from ..core.config import load_config_dir
    from ..train.loop import build_experiment

    cfg = load_config_dir(args.config)
    trainer = build_experiment(cfg, corpora=args.corpus, use_clf=args.use_clf,
                               restore_step=args.restore_step, checkpoint=args.checkpoint,
                               seed=args.seed, device=args.device,
                               use_flash=args.use_flash, bf16=args.bf16)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"Number of FastSpeech2 Parameters: {n_params}")
    return trainer.fit(restore_step=args.restore_step, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
