"""Sample speakers from a saved mid-attribute distribution and synthesize
(port of masg_tpu/cli/examples_gen_distri.py; reference
examples_gen_distri.py:128-231).

Loads a distribution (an `.npz` of (pi, mu, sigma) from `cli.build_distribution`
of either package, or the reference's torch-pickled InterpolateGMM /
BarycenterGMM `.pth`), samples `--n_speakers` voices from a seeded
`torch.Generator`, synthesizes a Japanese sample per voice and saves each
embedding (`.npy`) beside its wav.

    python -m masg_tpu_torch.cli.examples_gen_distri -c <config_dir> -r <step> \
        -d neutral.npz --n_speakers 8 --output_path out/ [--device cuda]

masg_tpu's XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_distribution(path: str):
    """A speaker distribution as the port's DiagGMM (float32 CPU tensors):
    an `.npz` of pi/mu/sigma, or the reference's torch-pickled
    InterpolateGMM/BarycenterGMM `.pth` (examples_gen_distri.py:207-215:
    `torch.load("distributions/*.pth")`).

    The reference pickles instances of its own `model.distributions.*`
    classes, which do not exist here: a stub unpickler stands in for any class
    it cannot import, so the inner torch distributions (Categorical probs,
    Independent(Normal) loc/scale) load as they are."""
    import pickle
    import types

    import torch

    from ..ops.gmm import DiagGMM

    if path.endswith(".npz"):
        z = np.load(path)
        return DiagGMM(*(torch.from_numpy(np.asarray(z[k], np.float32))
                         for k in ("pi", "mu", "sigma")))

    class _StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ModuleNotFoundError, AttributeError):
                # a class of the reference repo: an empty shell is enough,
                # only its __dict__ is read
                return type(name, (), {})

    shim = types.ModuleType("masg_tpu_torch_stub_pickle")  # torch wants a module
    shim.Unpickler = _StubUnpickler
    shim.load = lambda f, **kw: _StubUnpickler(f, **kw).load()
    d = torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False)

    def attr(obj, public, private):
        v = obj.__dict__.get(private) if hasattr(obj, "__dict__") else None
        return v if v is not None else getattr(obj, public)

    mix = attr(d, "mixture_distribution", "_mixture_distribution")
    comp = attr(d, "component_distribution", "_component_distribution")
    base = comp.base_dist if hasattr(comp, "base_dist") else comp
    return DiagGMM(pi=mix.probs.detach().float(), mu=base.loc.detach().float(),
                   sigma=base.scale.detach().float())


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
    parser.add_argument("-d", "--distribution", type=str, required=True,
                        help=".npz (pi/mu/sigma) or reference .pth distribution")
    parser.add_argument("--n_speakers", type=int, default=99)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--text_ja", type=str, default=None)
    parser.add_argument("--phones_ja", type=str,
                        default="{k o N n i ch i w a sp m i n a s a N}")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_vocoder", action="store_true")
    parser.add_argument("--vocoder_checkpoint", type=str, default=None,
                        help="HiFi-GAN generator checkpoint (torch {'generator': "
                             "state_dict} or masg_tpu's flax .msgpack)")
    parser.add_argument("--duration_control", type=float, default=1.0)
    args = parser.parse_args(argv)

    import torch

    from ..core.config import load_config_dir
    from ..infer.synthesis import load_model, save_synth_results, synthesize_batch
    from ..infer.vocoder import get_vocoder
    from ..ops.gmm import sample as gmm_sample
    from .synthesize import single_utterance_batch, warn_random_weights

    cfg = load_config_dir(args.config)
    warn_random_weights(args)
    model = load_model(cfg, args.checkpoint, device=args.device,
                       restore_step=args.restore_step)
    vocoder = None if args.no_vocoder else get_vocoder(
        cfg.model, cfg.config_dir, checkpoint=args.vocoder_checkpoint, device=args.device)
    gmm = load_distribution(args.distribution)
    os.makedirs(args.output_path, exist_ok=True)
    ids = japanese_ids(args.phones_ja, args.text_ja)

    gen = torch.Generator().manual_seed(args.seed)
    for i in range(1, args.n_speakers + 1):
        emb = gmm_sample(gmm, gen).reshape(1, -1).float().numpy()
        name = f"gen{i:0>3d}"
        batch = single_utterance_batch(ids, None)
        batch.update({"ids": [name + "_ja"], "raw_texts": [name]})
        out = synthesize_batch(model, batch, max_mel_len=cfg.model.max_seq_len,
                               d_control=args.duration_control, speaker_emb=emb)
        save_synth_results(cfg, batch, out, vocoder, args.output_path, write_figures=False)
        np.save(os.path.join(args.output_path, name + ".npy"), emb)
    print(f"{args.n_speakers} sampled speakers written to {args.output_path}")


def japanese_ids(phones: str, text=None):
    """Phone ids of `text` through the Japanese G2P, or of the phone string."""
    from ..text import phone_string_to_sequence, text_to_sequence

    if text is None:
        return phone_string_to_sequence(phones)
    from ..text.g2p import preprocess_japanese

    return text_to_sequence(preprocess_japanese(text)[0])


if __name__ == "__main__":
    main()
