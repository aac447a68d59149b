"""Sample a new speaker embedding from the metadata-conditioned GMM prior
(port of masg_tpu/cli/speaker_gen.py; reference speaker_gen.py:24-73):
one-hot(metadata) -> SpeakerMetaEncoder GMM -> sample -> generated_speaker.npy.
Deterministic under --seed (a `torch.Generator`).

    python -m masg_tpu_torch.cli.speaker_gen -c <config_dir> -r <step> --gender F \
        [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-r", "--restore_step", type=int, default=0,
                        help="checkpoint step to load from the config's ckpt_path (0 = "
                             "random init, for smoke tests only; the reference requires "
                             "a checkpoint)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="reference-format FastSpeech2 checkpoint "
                             "({'model': state_dict}), instead of -r")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--gender", type=str, default="F")
    parser.add_argument("--language", type=str, default=None,
                        help="optional language one-hot (e.g. ja)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-o", "--output", type=str, default="generated_speaker.npy")
    args = parser.parse_args(argv)

    import torch

    from ..core.config import load_config_dir
    from ..infer.synthesis import load_model
    from ..ops.gmm import sample as gmm_sample
    from .synthesize import warn_random_weights

    cfg = load_config_dir(args.config)
    warn_random_weights(args)
    model = load_model(cfg, args.checkpoint, device=args.device,
                       restore_step=args.restore_step)

    values = {}
    if args.gender:
        values["gender"] = args.gender
    if args.language:
        values["language"] = args.language
    meta = cfg.preprocess.speaker_generation.one_hot(values)[None, :]

    with torch.inference_mode():
        gmm = model.speaker_distribution(
            torch.as_tensor(meta, device=model.mel_linear.weight.device))
        emb = gmm_sample(gmm, torch.Generator().manual_seed(args.seed))
    emb = emb.float().cpu().numpy()
    np.save(args.output, emb[0])
    print(f"sampled speaker embedding {emb.shape[1:]} -> {args.output}")


if __name__ == "__main__":
    main()
