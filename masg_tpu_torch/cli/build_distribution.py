"""Build a mid-attribute speaker distribution offline (port of
masg_tpu/cli/build_distribution.py).

The W2 interpolation between two metadata corners of the TacoSpawn prior
(InterpolateGMM), or the W2 barycenter over all corners (BarycenterGMM),
saved as (pi, mu, sigma) in an `.npz` that either package reads (reference:
distributions.py used interactively, then torch.save of the result,
examples_gen_distri.py:207-215).

    python -m masg_tpu_torch.cli.build_distribution -c <config_dir> -r <step> \
        --mode barycenter -o neutral.npz [--device cuda]

masg_tpu's XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-r", "--restore_step", type=int, default=0,
                        help="checkpoint step to load from the config's ckpt_path "
                             "(0 = random prior, smoke tests only)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="reference-format FastSpeech2 checkpoint "
                             "({'model': state_dict}), instead of -r")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--mode", choices=["interpolate", "barycenter"], default="barycenter")
    parser.add_argument("--corner_a", type=str, nargs="*",
                        default=["gender=M", "language=ja"],
                        help="metadata values for endpoint A (interpolate mode)")
    parser.add_argument("--corner_b", type=str, nargs="*",
                        default=["gender=F", "language=ja"])
    parser.add_argument("--t", type=float, default=0.5, help="interpolation rate")
    parser.add_argument("--rates", type=float, nargs="*", default=None,
                        help="barycenter rates (default uniform over corners)")
    parser.add_argument("-o", "--output", type=str, required=True, help=".npz path")
    args = parser.parse_args(argv)

    import torch

    from ..core.config import load_config_dir
    from ..distributions.wasserstein import BarycenterGMM, InterpolateGMM, metadata_corners
    from ..infer.synthesis import load_model

    cfg = load_config_dir(args.config)
    model = load_model(cfg, args.checkpoint, device=args.device,
                       restore_step=args.restore_step)
    schema = cfg.preprocess.speaker_generation
    dev = model.mel_linear.weight.device

    def prior(meta_vec):
        with torch.inference_mode():
            return model.speaker_distribution(
                torch.as_tensor(np.asarray(meta_vec, np.float32)[None, :], device=dev))

    if args.mode == "interpolate":
        def parse_corner(kvs):
            return schema.one_hot(dict(kv.split("=") for kv in kvs))

        gmm = InterpolateGMM(prior(parse_corner(args.corner_a)),
                             prior(parse_corner(args.corner_b))).interpolate_rate(args.t)
    else:
        gmm = BarycenterGMM([prior(c) for c in metadata_corners(schema.metadata)],
                            rates=args.rates).gmm

    np.savez(args.output, pi=gmm.pi.numpy(), mu=gmm.mu.numpy(), sigma=gmm.sigma.numpy())
    print(f"{args.mode} distribution ({gmm.pi.shape[-1]} components) -> {args.output}")
    return gmm


if __name__ == "__main__":
    main()
