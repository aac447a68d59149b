"""The mid-attribute speaker-generation demo on the card, one command (port
of scripts/demo_mid_attribute.py:52-137; reference flow:
examples_gen_distri.py:128-231).

    python -m masg_tpu_torch.demo.mid_attribute --out DIR [--device cuda|cpu]
        [--fs2_steps 1200] [--vocoder_steps 4000] [--n_speakers_sampled 3]

  1. a bilingual vocal corpus (4 speakers over every gender x language
     corner) and `cli.preprocess`;
  2. the multi-speaker FastSpeech2 + TacoSpawn speaker prior (`cli.train`);
  3. the demo HiFi-GAN on the corpus wavs (`cli.train_vocoder`);
  4. the mid-attribute distributions: the W2 interpolation of the M/ja and
     F/ja corners at t = 0.5 and the W2 barycenter of all four corners;
  5. new speakers sampled from each, speaking Japanese through the vocoder.

The wavs, embeddings and distributions land under --out; each stage's wall
time and K1-K4 launches are printed. Its stages are `demo/stages.py`'s.
"""

from __future__ import annotations

import argparse

from . import stages as S


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--fs2_steps", type=int, default=1200)
    ap.add_argument("--vocoder_steps", type=int, default=4000,
                    help="masg_tpu's probe (scripts/probe_vocoder_audibility.py): the "
                         "amplitude tracks the ground truth from ~1000 steps")
    ap.add_argument("--n_speakers_sampled", type=int, default=3)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    clock = S.StageClock()
    cfg_dir = S.build_corpus(args.out, n_speakers=4, utts_per_speaker=20,
                             fs2_steps=args.fs2_steps, voice_variation=False, log_step=200,
                             device=args.device)
    clock.mark(f"corpus + preprocess ({cfg_dir})")
    S.pretrain_fs2(cfg_dir, args.fs2_steps, args.device)
    clock.mark(f"FastSpeech2 trained {args.fs2_steps} steps")
    gen_ckpt = S.train_vocoder(args.out, cfg_dir, args.vocoder_steps, 100, args.device)
    clock.mark(f"HiFi-GAN trained {args.vocoder_steps} steps -> {gen_ckpt}")
    npz = S.build_distributions(args.out, cfg_dir, args.fs2_steps, args.device)
    clock.mark(f"distributions built: {npz}")
    for name, path in npz.items():
        ws = S.synthesize_wavs(args.out, cfg_dir, args.fs2_steps, {name: path}, gen_ckpt,
                               args.n_speakers_sampled, args.device)[name]
        clock.mark(f"{name}: {len(ws)} wavs in {args.out}/wavs_{name}: {sorted(ws)}")

    print("\n=== mid-attribute demo complete ===")
    for name, t, launches in clock.stages:
        print(f"  +{t:7.1f}s  {name}  launches {launches}")
    return clock.stages


if __name__ == "__main__":
    main()
