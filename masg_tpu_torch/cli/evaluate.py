"""Standalone evaluation CLI (port of masg_tpu/cli/evaluate.py).

    python -m masg_tpu_torch.cli.evaluate -c <config_dir> --restore_step N
        [--split val.txt|test.txt] [--device cuda|cpu] [--no-use_flash]

Dataset-size-weighted mean validation losses of a saved step (reference
evaluate.py:18-113).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--restore_step", type=int, required=True)
    parser.add_argument("--corpus", type=str, nargs="*", default=None)
    parser.add_argument("--split", type=str, default="val.txt",
                        choices=["val.txt", "test.txt"],
                        help="metadata split to evaluate (reference "
                             "evaluate.py:32-33 always uses val.txt)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--use_flash", action=argparse.BooleanOptionalAction, default=True,
                        help="attention through the flash kernel")
    args = parser.parse_args(argv)

    from ..core.config import load_config_dir
    from ..train.loop import build_experiment

    cfg = load_config_dir(args.config)
    trainer = build_experiment(cfg, corpora=args.corpus, restore_step=args.restore_step,
                               device=args.device, use_flash=args.use_flash,
                               val_split=args.split)
    means = trainer.evaluate(args.restore_step)
    if means:
        print("Validation Step {}, Total Loss: {:.4f}, Mel Loss: {:.4f}, "
              "Mel PostNet Loss: {:.4f}, Pitch Loss: {:.4f}, Energy Loss: {:.4f}, "
              "Duration Loss: {:.4f}".format(args.restore_step, *means))
    return means


if __name__ == "__main__":
    main()
