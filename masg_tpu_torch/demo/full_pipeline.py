"""The complete paper recipe on the card, one command (port of
scripts/demo_full_pipeline.py:61-417).

    python -m masg_tpu_torch.demo.full_pipeline --out DIR [--device cuda|cpu]
        [--n_speakers 4] [--utts_per_speaker 20] [--fs2_steps 800]
        [--clf_steps 400] [--lambda 1.0] [--ge2e_epochs 40]
        [--vocoder_steps 4000] [--n_speakers_sampled 3] [--min_peak 0.1]

The reference recipe (train.sh:12-19, the GE2E submodule's
train_speech_embedder.py:115-248, train.py:74-91), stage by stage
(`demo/stages.py`):

  1. a bilingual vocal corpus (speakers over every gender x language corner,
     distinct voices) and `cli.preprocess`;
  2. GE2E chunk archives from each speaker's concatenated voiced spans;
  3. the paper's stage 1: the GE2E speaker encoder
     (`cli.train_speech_embedder`, the DA gate live for the second half),
     and its speaker-verification EER;
  4. the FastSpeech2 pretrain (plain multi-speaker + the TacoSpawn prior);
  5. the paper's stage 2: `--use_clf` at one lambda, warm-started from the
     pretrain, against the stage-3 encoder; and the adversarial branch's
     liveness (one step at lambda 0 against one at 1000);
  6. the demo HiFi-GAN trained to audibility, and a copy synthesis of each
     speaker's ground truth through it;
  7. the W2 interpolation and barycenter distributions from the fine-tuned
     model, new speakers sampled from them and spoken through the vocoder;
  8. the F0 gender score of those wavs between the corpus's corners.

`main` asserts masg_tpu's seven checks at its thresholds: (1) the GE2E loss
of the last epoch is below 0.7 x the first's; (2) the EER is under 0.35;
(3) the discriminator BCE was logged, finite and positive; (4) the lambda 0
against 1000 parameter delta exceeds 1e-6; (5) the copy-synthesis MCD is
reported (finite); (6) the demo wavs' median peak is >= --min_peak of full
scale; (7) their median F0 gender score lies in (0.05, 0.95). It writes
`<out>/evidence.json` (stage times, the K1-K4 launches of each stage, the
evidence, the checks) whether or not they hold.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional

import numpy as np

from . import stages as S


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_speakers", type=int, default=4,
                    help="multiple of 4: speakers cycle the (gender x language) corners, "
                         "n/4 per corner")
    ap.add_argument("--utts_per_speaker", type=int, default=20)
    ap.add_argument("--fs2_steps", type=int, default=800)
    ap.add_argument("--clf_steps", type=int, default=400)
    ap.add_argument("--lambda", dest="lambd", type=float, default=1.0)
    ap.add_argument("--ge2e_epochs", type=int, default=40)
    ap.add_argument("--vocoder_steps", type=int, default=4000,
                    help="masg_tpu's probe (scripts/probe_vocoder_audibility.py): the "
                         "amplitude tracks the ground truth from ~1000 steps")
    ap.add_argument("--n_speakers_sampled", type=int, default=3)
    ap.add_argument("--min_peak", type=float, default=0.1,
                    help="audibility floor asserted on the demo wavs")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(out: str, *, n_speakers: int = 4, utts_per_speaker: int = 20, fs2_steps: int = 800,
        clf_steps: int = 400, lambd: float = 1.0, ge2e_epochs: int = 40,
        vocoder_steps: int = 4000, n_speakers_sampled: int = 3, min_peak: float = 0.1,
        hifigan: Optional[dict] = None, device: str = "cuda") -> dict:
    """Every stage at these budgets (`hifigan`: the vocoder's config, default
    DEMO_HIFIGAN). Returns {"stages", "evidence", "checks"}, checks as name ->
    [holds, value], and writes them to <out>/evidence.json."""
    hifigan = hifigan or S.DEMO_HIFIGAN
    os.makedirs(out, exist_ok=True)
    clock = S.StageClock()
    ev = {}

    cfg_dir = S.build_corpus(out, n_speakers=n_speakers, utts_per_speaker=utts_per_speaker,
                             fs2_steps=fs2_steps, voice_variation=True, log_step=100,
                             hifigan=hifigan, device=device)
    clock.mark(f"corpus + preprocess ({cfg_dir})")

    spk_map, ge2e_data, n_chunks = S.ge2e_chunks(out)
    clock.mark(f"GE2E chunks: {n_chunks}")

    losses, enc_ckpt = S.train_ge2e(out, ge2e_data, ge2e_epochs, device=device)
    ev["ge2e_first_epoch_loss"], ev["ge2e_last_epoch_loss"] = losses[0], losses[-1]
    clock.mark(f"STAGE 1 GE2E trained: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
               f"{ge2e_epochs} epochs")

    ev["ge2e_eer"], ev["ge2e_eer_threshold"] = S.ge2e_eer(enc_ckpt, ge2e_data, device=device)
    clock.mark(f"GE2E EER {ev['ge2e_eer']:.3f} @ threshold {ev['ge2e_eer_threshold']:.2f} "
               f"(gate < 0.35)")

    pretrain_ckpt = S.pretrain_fs2(cfg_dir, fs2_steps, device)
    clock.mark(f"FS2 pretrained {fs2_steps} steps ({pretrain_ckpt})")

    clf_cfg_dir, dl = S.finetune_clf(out, cfg_dir, enc_ckpt, pretrain_ckpt, clf_steps, lambd,
                                     device)
    ev["clf_dloss"] = dl
    if dl:
        ev["clf_dloss_first"], ev["clf_dloss_last"] = dl[0], dl[-1]
    ev["clf_liveness_max_param_delta"] = S.clf_liveness(out, clf_cfg_dir, pretrain_ckpt,
                                                        device)
    clock.mark(f"STAGE 2 --use_clf fine-tune (lambda={lambd}): disc BCE "
               f"{[round(v, 3) for _, v in dl[:1] + dl[-1:]]}; lambda 0 vs 1000 parameter "
               f"delta {ev['clf_liveness_max_param_delta']:.2e}")

    gen_ckpt = S.train_vocoder(out, cfg_dir, vocoder_steps, 200, device)
    clock.mark(f"HiFi-GAN trained {vocoder_steps} steps -> {gen_ckpt}")
    peaks, mcds = S.copy_synthesis(gen_ckpt, hifigan,
                                   [spk_map[s][0][0] for s in sorted(spk_map)], device)
    ev["vocoder_copy_synthesis_peak_median"] = float(np.median(peaks))
    ev["vocoder_copy_synthesis_mcd_db"] = float(np.mean(mcds))
    clock.mark(f"vocoder copy-synthesis: peak median {np.median(peaks):.3f} FS, MCD "
               f"{np.mean(mcds):.2f} dB")

    npz = S.build_distributions(out, clf_cfg_dir, clf_steps, device)
    clock.mark(f"distributions built: {npz}")
    wavs = S.synthesize_wavs(out, clf_cfg_dir, clf_steps, npz, gen_ckpt, n_speakers_sampled,
                             device)
    peaks = [float(np.abs(w).max()) for ws in wavs.values() for w in ws.values()]
    ev["demo_wav_peak_median"] = float(np.median(peaks))
    ev["demo_wav_peak_min"] = float(np.min(peaks))
    clock.mark(f"{sum(len(w) for w in wavs.values())} wavs: peak median "
               f"{ev['demo_wav_peak_median']:.3f} FS (min {ev['demo_wav_peak_min']:.3f})")

    gt_f0, scores = S.f0_gender_scores(spk_map, wavs)
    ev["mid_attribute_f0"] = {"gt_f0_hz": gt_f0, "scores": scores}  # 0 = M, 1 = F corner
    med = float(np.median(sum(scores.values(), [])))
    ev["mid_attribute_f0_score_median"] = med
    clock.mark(f"MID-ATTRIBUTE: F0 gender scores {scores} (0 = M corner, 1 = F corner; "
               f"ground truth {gt_f0['M']:.0f} / {gt_f0['F']:.0f} Hz)")

    checks = {
        "ge2e_loss_falls": [losses[-1] < 0.7 * losses[0], [losses[0], losses[-1]]],
        "ge2e_eer_below_0.35": [ev["ge2e_eer"] < 0.35, ev["ge2e_eer"]],
        "clf_bce_logged_finite_positive": [
            bool(dl) and all(math.isfinite(v) and v > 0 for _, v in dl),
            [v for _, v in dl[:1] + dl[-1:]]],
        "clf_liveness_delta_above_1e-6": [ev["clf_liveness_max_param_delta"] > 1e-6,
                                          ev["clf_liveness_max_param_delta"]],
        "copy_synthesis_mcd_reported": [math.isfinite(ev["vocoder_copy_synthesis_mcd_db"]),
                                        ev["vocoder_copy_synthesis_mcd_db"]],
        f"wav_peak_median_at_least_{min_peak}": [ev["demo_wav_peak_median"] >= min_peak,
                                                 ev["demo_wav_peak_median"]],
        "f0_score_median_in_(0.05,0.95)": [0.05 < med < 0.95, med],
    }
    checks = {k: [bool(ok), v] for k, (ok, v) in checks.items()}
    result = {"stages": clock.stages, "evidence": ev, "checks": checks}
    with open(os.path.join(out, "evidence.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> dict:
    args = parse_args(argv)
    result = run(args.out, n_speakers=args.n_speakers, utts_per_speaker=args.utts_per_speaker,
                 fs2_steps=args.fs2_steps, clf_steps=args.clf_steps, lambd=args.lambd,
                 ge2e_epochs=args.ge2e_epochs, vocoder_steps=args.vocoder_steps,
                 n_speakers_sampled=args.n_speakers_sampled, min_peak=args.min_peak,
                 device=args.device)
    print("\n=== full pipeline demo complete ===")
    for name, t, launches in result["stages"]:
        print(f"  +{t:7.1f}s  {name}  launches {launches}")
    print("evidence:", json.dumps(result["evidence"], indent=1))
    failed = {k: v for k, (ok, v) in result["checks"].items() if not ok}
    for k, (ok, v) in result["checks"].items():
        print(f"check {k}: {'holds' if ok else 'FAILS'} ({v})")
    assert not failed, f"demo checks failed: {failed}"
    return result


if __name__ == "__main__":
    main()
