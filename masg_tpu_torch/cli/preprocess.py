"""Preprocessing CLI (port of masg_tpu/cli/preprocess.py).

    python -m masg_tpu_torch.cli.preprocess --config <config_dir>
        [--corpus A B ...] [--device cuda|cpu]

The reference's `python preprocess.py --config <config_dir>` (preprocess.py:
8-35): feature extraction for each preprocess_<CORPUS>.yaml of the config
dir, with per-corpus normalization off when there are several corpora (their
global statistics come from `gather` afterwards, preprocess.py:15-16). The
STFT runs on `--device` (default `cuda`), F0 on the host. Each corpus ends
with a line of milliseconds per utterance, split into its parts
(`Preprocessor.seconds`); `main` returns the corpora's `Preprocessor`s.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--corpus", type=str, nargs="*", default=None)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..core.config import load_config_dir
    from ..device import resolve_device
    from ..preprocessor.preprocessor import Preprocessor
    from ..train.loop import build_corpus_dict

    device = resolve_device(args.device)
    cfg = load_config_dir(args.config)
    names = args.corpus or list(cfg.corpora)
    multi = len(names) > 1
    done = {}
    for name in names:
        d = build_corpus_dict(cfg, name)
        if multi:
            # normalization off; gather recomputes global stats (preprocess.py:15-16)
            pp = d["preprocessing"]
            pp["pitch"] = dict(pp["pitch"], normalization=False)
            pp["energy"] = dict(pp["energy"], normalization=False)
        print(f"=== preprocessing {name} ===")
        pre = done[name] = Preprocessor(d, device=device)
        pre.build_from_path()
        n, sec = pre.n_utterances, pre.seconds
        parts = ", ".join(f"{k} {sec[k] / max(n, 1) * 1e3:.2f}" for k in sec if k != "total")
        print(f"{n} utterances in {sec['total']:.2f} s on {device}: "
              f"{sec['total'] / max(n, 1) * 1e3:.2f} ms per utterance ({parts})")
    return done


if __name__ == "__main__":
    main()
