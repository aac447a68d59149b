"""Where the full-pipeline demo's F0 check breaks: the vocoder or the model.

    python -m masg_tpu_torch.demo.probe --out DIR [--steps 1000 2000 4000]
        [--generator G ...] [--device cuda|cpu]

DIR holds a finished `demo.full_pipeline` run (its corpus, concatenated
ground-truth wavs, both FastSpeech2 runs and its vocoder). For each HiFi-GAN
checkpoint, the run's own vocoder trained on (resumed from its last
`vocoder_{step}.pth.tar`, with a generator saved at each of --steps) or each
`--generator` file given (a torch or masg_tpu `.msgpack` generator, copy
synthesis only):

- copy synthesis of each speaker's ground truth: the output's peak, its RMS
  against the ground truth's, its share of samples at full scale (|x| >
  0.99), its mean voiced F0 against the ground truth's (0 when unvoiced);
- the wavs that the pretrained model and the `--use_clf` model speak from
  their W2 distributions through it: their peaks and F0 gender scores, the
  demo's check 7 (0 at the M corner, 1 at F, in (0.05, 0.95) to pass).

Prints one JSON line a checkpoint and writes DIR/probe.json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from . import stages as S


def speaker_map(out: str) -> Dict[str, Tuple[List[str], str, str]]:
    """speaker -> ([its concatenated ground-truth wav], gender, language) of
    the run in `out` (`stages.ge2e_chunks` wrote the wavs)."""
    with open(os.path.join(out, "preprocessed_data", S.DATASET, "speakers.json")) as f:
        speakers = json.load(f)
    return {spk: ([os.path.join(out, "ge2e_cat_wavs", f"{spk}.wav")], gender, lang)
            for spk, (_sid, gender, lang) in speakers.items()}


def copy_synthesis_rows(generator: str, hifigan: dict, spk_map,
                        device: str) -> Dict[str, dict]:
    from ..eval.attribute_probe import mean_voiced_f0

    spks = sorted(spk_map)
    rows = S.vocode_ground_truth(generator, hifigan, [spk_map[s][0][0] for s in spks], device)
    return {spk: {"peak": float(np.abs(out).max()),
                  "rms": float(np.sqrt(np.mean(out ** 2))),
                  "gt_rms": float(np.sqrt(np.mean(gt ** 2))),
                  "full_scale_share": float(np.mean(np.abs(out) > 0.99)),
                  "f0": mean_voiced_f0(out.astype(np.float64)),
                  "gt_f0": mean_voiced_f0(gt.astype(np.float64))}
            for spk, (gt, _, out, _) in zip(spks, rows)}


def model_wavs(out: str, name: str, cfg_dir: str, step: int, generator: str, spk_map,
               device: str) -> dict:
    """Check 7's wavs of the model at `cfg_dir`/`step` through `generator`,
    under <out>/probe/<name>/<generator's file name>."""
    sub = os.path.join(out, "probe", name, os.path.basename(generator).split(".")[0])
    os.makedirs(sub, exist_ok=True)
    npz = S.build_distributions(sub, cfg_dir, step, device)
    wavs = S.synthesize_wavs(sub, cfg_dir, step, npz, generator, 3, device)
    _, scores = S.f0_gender_scores(spk_map, wavs)
    return {"scores": scores,
            "peaks": [float(np.abs(w).max()) for ws in wavs.values() for w in ws.values()],
            "median_score": float(np.median(sum(scores.values(), [])))}


def total_step(cfg_dir: str) -> int:
    import yaml

    with open(os.path.join(cfg_dir, "train.yaml")) as f:
        return int(yaml.safe_load(f)["step"]["total_step"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="a finished demo.full_pipeline run")
    ap.add_argument("--steps", type=int, nargs="*", default=[],
                    help="vocoder steps to train the run's vocoder on to, a generator at each")
    ap.add_argument("--generator", nargs="*", default=[],
                    help="generator checkpoints to copy-synthesize with instead")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spk_map = speaker_map(args.out)
    with open(os.path.join(args.out, "config", "hifigan_config.json")) as f:
        hifigan = json.load(f)
    result = {}
    generators = list(args.generator)
    if args.steps:
        cfg_dir = os.path.join(args.out, "config")
        done = sorted(glob.glob(os.path.join(args.out, "vocoder", "vocoder_*.pth.tar")),
                      key=lambda p: int(re.findall(r"\d+", os.path.basename(p))[0]))
        steps = sorted(args.steps)
        gaps = np.diff([0] + steps)
        S.train_vocoder(args.out, cfg_dir, steps[-1], 500, args.device,
                        save_step=int(np.gcd.reduce(gaps)), restore=done[-1] if done else None)
        generators += [os.path.join(args.out, "vocoder", f"generator_{n}.pth.tar")
                       for n in steps]
    models = {"pretrain": os.path.join(args.out, "config"),
              "use_clf": os.path.join(args.out, "config_langemb")}
    for g in generators:
        row = {"copy_synthesis": copy_synthesis_rows(g, hifigan, spk_map, args.device)}
        if args.steps:
            for name, cfg in models.items():
                row[name] = model_wavs(args.out, name, cfg, total_step(cfg), g, spk_map,
                                       args.device)
        result[g] = row
        print(json.dumps({g: row}), flush=True)
    with open(os.path.join(args.out, "probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
