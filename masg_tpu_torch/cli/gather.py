# Copied verbatim from masg_tpu/cli/gather.py so the port imports nothing of the JAX package.
"""Multi-corpus stats merge CLI.

Equivalent of the reference's `python gather.py --config <config_dir>`
(gather.py:1-75): recompute global pitch/energy stats.json + merged global
speakers.json across all corpora into the config dir.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def gather(config_dir: str) -> None:
    from ..core.config import load_config_dir
    from ..preprocessor.preprocessor import RunningStats

    cfg = load_config_dir(config_dir)
    normalize_pitch = cfg.preprocess.pitch.normalization
    normalize_energy = cfg.preprocess.energy.normalization

    speakers = {}
    total = 0
    mins = {"pitch": float("inf"), "energy": float("inf")}
    maxs = {"pitch": -float("inf"), "energy": -float("inf")}
    scalers = {"pitch": RunningStats(), "energy": RunningStats()}

    for name, cc in cfg.corpora.items():
        pre = cc.preprocessed_path
        with open(os.path.join(pre, "speakers.json")) as f:
            speaker_json = json.load(f)
        for spk in speaker_json:
            speakers[spk] = [total, *speaker_json[spk][1:]]
            total += 1
        for kind in ("pitch", "energy"):
            d = os.path.join(pre, kind)
            for fn in os.listdir(d):
                vals = np.load(os.path.join(d, fn))
                scalers[kind].update(vals.reshape(-1))
                maxs[kind] = max(maxs[kind], float(vals.max()))
                mins[kind] = min(mins[kind], float(vals.min()))

    def norm_stats(kind, normalize):
        mean = scalers[kind].mean if normalize else 0.0
        std = scalers[kind].std if normalize else 1.0
        return [
            float((mins[kind] - mean) / std),
            float((maxs[kind] - mean) / std),
            float(mean),
            float(std),
        ]

    stats = {
        "pitch": norm_stats("pitch", normalize_pitch),
        "energy": norm_stats("energy", normalize_energy),
    }
    with open(os.path.join(config_dir, "speakers.json"), "w") as f:
        json.dump(speakers, f)
    with open(os.path.join(config_dir, "stats.json"), "w") as f:
        json.dump(stats, f)
    print(f"gathered {total} speakers; stats -> {config_dir}/stats.json")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    gather(args.config)


if __name__ == "__main__":
    main()
