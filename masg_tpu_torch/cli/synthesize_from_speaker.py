"""Synthesis from a raw speaker-embedding vector, bypassing the table (port of
masg_tpu/cli/synthesize_from_speaker.py; reference
synthesize_from_speaker.py:106-261 -> model.synthesize_from_speaker_emb).

    python -m masg_tpu_torch.cli.synthesize_from_speaker -c <config_dir> \
        -r <step> -s generated_speaker.npy --phones '{k o N n i ch i w a}' [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from .synthesize import add_model_args, load_models, phone_ids, single_utterance_batch


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    parser.add_argument("-t", "--text", type=str, default=None)
    parser.add_argument("--phones", type=str, default=None)
    parser.add_argument("--accents", type=str, default=None)
    parser.add_argument("-s", "--speaker_emb", type=str, required=True,
                        help="path to a .npy embedding (e.g. from speaker_gen)")
    parser.add_argument("-l", "--language", type=str, default="ja",
                        choices=["ja", "en", "zh"])
    parser.add_argument("--use_accent", action="store_true")
    args = parser.parse_args(argv)

    from ..core.config import load_config_dir
    from ..infer.synthesis import save_synth_results, synthesize_batch

    cfg = load_config_dir(args.config)
    model, vocoder = load_models(args, cfg)
    emb = np.load(args.speaker_emb)
    if emb.ndim == 1:
        emb = emb[None, :]
    ids, accents_ids, raw_text = phone_ids(args, cfg)

    batch = single_utterance_batch(ids, accents_ids)
    batch.update({
        "ids": ["from_emb_" + (raw_text[:16].replace(" ", "_") or "utt")],
        "raw_texts": [raw_text],
    })
    output = synthesize_batch(
        model, batch, p_control=args.pitch_control, e_control=args.energy_control,
        d_control=args.duration_control,
        max_mel_len=args.max_frames or cfg.model.max_seq_len,
        speaker_emb=emb.astype(np.float32))
    result_path = args.result_path or cfg.train.path.result_path
    written = save_synth_results(cfg, batch, output, vocoder, result_path)
    print(f"mel_len={int(output.mel_len[0])} -> {result_path}")
    for w in written:
        print("wrote", w)


if __name__ == "__main__":
    main()
