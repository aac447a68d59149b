"""Batch demo generation: every table speaker, then freshly sampled speakers
(port of masg_tpu/cli/examples_gen.py; reference examples_gen.py:114-273).

For each table speaker, a Japanese and an English sample from its
embedding; then for each (language x gender) metadata corner,
(n_speakers - 1) // 4 new speakers sampled from the GMM prior, each in both
languages. Every embedding is saved as `.npy` beside its wavs. Samples come
from a `torch.Generator` seeded with `--seed` (masg_tpu draws from JAX's RNG,
so the same seed gives other voices there).

    python -m masg_tpu_torch.cli.examples_gen -c <config_dir> -r <step> \
        --output_path out/ [--device cuda]

masg_tpu's XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import os

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
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--text_ja", type=str, default=None)
    parser.add_argument("--text_en", type=str, default=None)
    parser.add_argument("--phones_ja", type=str,
                        default="{k o N n i ch i w a sp m i n a s a N}")
    parser.add_argument("--phones_en", type=str, default="{h h a l o sp w o l d}")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_vocoder", action="store_true")
    parser.add_argument("--vocoder_checkpoint", type=str, default=None,
                        help="HiFi-GAN generator checkpoint (torch {'generator': "
                             "state_dict} or masg_tpu's flax .msgpack)")
    parser.add_argument("--max_real_speakers", type=int, default=None,
                        help="cap table-speaker synthesis (demo runs)")
    parser.add_argument("--duration_control", type=float, default=1.0)
    args = parser.parse_args(argv)

    import torch

    from ..core.config import load_config_dir
    from ..infer.synthesis import load_model, save_synth_results, synthesize_batch
    from ..infer.vocoder import get_vocoder
    from ..ops.gmm import sample as gmm_sample
    from .examples_gen_distri import japanese_ids
    from .synthesize import single_utterance_batch, warn_random_weights

    cfg = load_config_dir(args.config)
    warn_random_weights(args)
    model = load_model(cfg, args.checkpoint, device=args.device,
                       restore_step=args.restore_step)
    vocoder = None if args.no_vocoder else get_vocoder(
        cfg.model, cfg.config_dir, checkpoint=args.vocoder_checkpoint, device=args.device)
    os.makedirs(args.output_path, exist_ok=True)
    dev = model.mel_linear.weight.device

    ids = {"ja": japanese_ids(args.phones_ja, args.text_ja),
           "en": english_ids(args.phones_en, args.text_en)}

    def synth_with_emb(emb, name):
        for lang in ("ja", "en"):
            batch = single_utterance_batch(ids[lang], None)
            batch.update({"ids": [f"{name}_{lang}"], "raw_texts": [name]})
            out = synthesize_batch(model, batch, max_mel_len=cfg.model.max_seq_len,
                                   d_control=args.duration_control, speaker_emb=emb)
            save_synth_results(cfg, batch, out, vocoder, args.output_path,
                               write_figures=False)
        np.save(os.path.join(args.output_path, name + ".npy"), emb)

    # 1) every table speaker (examples_gen.py:247-256)
    speakers = cfg.speakers or {}
    table = model.speaker_emb.weight.detach().float().cpu().numpy()
    names = [n for n in speakers if n != "JSUT"]
    if args.max_real_speakers:
        names = names[: args.max_real_speakers]
    for speaker_name in names:
        sid = speakers[speaker_name][0]
        synth_with_emb(table[sid: sid + 1], speaker_name)

    # 2) (language x gender) prior samples (examples_gen.py:258-273)
    gen = torch.Generator().manual_seed(args.seed)
    n_new = max(1, (len(speakers) - 1) // 4) if speakers else 1
    schema = cfg.preprocess.speaker_generation
    for language in ("ja", "en"):
        for gender in ("M", "F"):
            meta = schema.one_hot({"gender": gender, "language": language})[None, :]
            with torch.inference_mode():
                gmm = model.speaker_distribution(torch.as_tensor(meta, device=dev))
            for i in range(1, n_new + 1):
                emb = gmm_sample(gmm, gen).float().cpu().numpy()
                synth_with_emb(emb, f"{gender}_{language}gen{i:0>3d}")
    print(f"examples written to {args.output_path}")


def english_ids(phones: str, text=None):
    """Phone ids of `text` through the English G2P, or of the phone string."""
    from ..text import phone_string_to_sequence, text_to_sequence

    if text is None:
        return phone_string_to_sequence(phones)
    from ..text.g2p import preprocess_english

    return text_to_sequence(preprocess_english(text))


if __name__ == "__main__":
    main()
