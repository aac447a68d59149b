"""Single-sentence synthesis CLI (port of masg_tpu/cli/synthesize.py).

    python -m masg_tpu_torch.cli.synthesize -c <config_dir> -r <step> \
        --phones '{k o N n i ch i w a}' [--vocoder_checkpoint g.pth] [--device cuda]

The flags are masg_tpu's: `-r/--restore_step` restores the model that
`masg_tpu_torch.cli.train` saved at that step under the config's ckpt_path
(0, the default: random weights). Added: `--checkpoint` (a reference-format
`{"model": state_dict}` file, instead of `-r`), `--vocoder_checkpoint`,
`--device` (default `cuda`), `--use_flash` and `--fused_mrf` (both on by
default).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """The flags every synthesis CLI of the port shares."""
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-r", "--restore_step", type=int, default=0,
                        help="checkpoint step to load from the config's ckpt_path (0 = "
                             "random init, for smoke tests only; the reference requires "
                             "a checkpoint)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="reference-format FastSpeech2 checkpoint "
                             "({'model': state_dict}), instead of -r")
    parser.add_argument("--vocoder_checkpoint", type=str, default=None,
                        help="HiFi-GAN generator checkpoint ({'generator': state_dict})")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--use_flash", action=argparse.BooleanOptionalAction,
                        default=True, help="attention through the flash kernel")
    parser.add_argument("--fused_mrf", action=argparse.BooleanOptionalAction,
                        default=True, help="narrow MRF stages through the fused kernel")
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--no_vocoder", action="store_true")
    parser.add_argument("--max_frames", type=int, default=None,
                        help="mel frame cap (default model.max_seq_len)")
    parser.add_argument("--result_path", type=str, default=None)


def phone_ids(args, cfg):
    """(ids, accent_ids or None, raw_text) from --phones/--accents or --text."""
    from ..text import ACCENT_TO_ID, phone_string_to_sequence, text_to_sequence

    if args.phones:
        ids = phone_string_to_sequence(args.phones)
        accents_ids = ([ACCENT_TO_ID[c] for c in args.accents][: len(ids)]
                       if args.accents else None)
        return ids, accents_ids, args.phones
    if args.text is None:
        raise SystemExit("need --text or --phones")
    accents_ids = None
    if args.language == "ja":
        from ..text.g2p import preprocess_japanese

        phones, accents = preprocess_japanese(args.text)
        ids = text_to_sequence(phones)
        if args.use_accent:
            accents_ids = [ACCENT_TO_ID[c] for c in accents][: len(ids)]
    elif args.language == "en":
        from ..text.g2p import preprocess_english

        phones = preprocess_english(args.text)
        print("Raw Text Sequence: {}".format(args.text))
        print("Phoneme Sequence: {}".format(phones))
        ids = text_to_sequence(phones)
    else:
        from ..text import pinyin_to_sequence
        from ..text.g2p import preprocess_mandarin, resolve_lexicon_path

        phones = preprocess_mandarin(
            args.text, resolve_lexicon_path(getattr(args, "lexicon", None), cfg.config_dir))
        ids = pinyin_to_sequence(phones)
    return ids, accents_ids, args.text


def single_utterance_batch(ids, accents_ids):
    """texts/src_lens/accents for one utterance, padded to a multiple of 16."""
    from ..infer.synthesis import round_up
    from ..text import NO_ACCENT_ID

    width = round_up(len(ids), 16)
    texts = np.zeros((1, width), np.int32)
    texts[0, : len(ids)] = ids
    acc = np.zeros((1, width), np.int32)
    if accents_ids is not None:
        acc[0, : len(accents_ids)] = accents_ids
    else:
        acc[0, : len(ids)] = NO_ACCENT_ID
    return {"texts": texts, "src_lens": np.array([len(ids)], np.int32), "accents": acc}


def warn_random_weights(args) -> None:
    """masg_tpu's warning for a run with neither -r nor --checkpoint."""
    if args.restore_step == 0 and not args.checkpoint:
        print("WARNING: --restore_step 0 synthesizes with RANDOM weights")


def load_models(args, cfg):
    """(FastSpeech2, Vocoder or None) on --device."""
    from ..infer.synthesis import load_model
    from ..infer.vocoder import get_vocoder

    warn_random_weights(args)
    model = load_model(cfg, args.checkpoint, device=args.device, use_flash=args.use_flash,
                       restore_step=args.restore_step)
    vocoder = None if args.no_vocoder else get_vocoder(
        cfg.model, cfg.config_dir, args.vocoder_checkpoint, device=args.device,
        fused_mrf=args.fused_mrf)
    return model, vocoder


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    parser.add_argument("-t", "--text", type=str, default=None)
    parser.add_argument("--phones", type=str, default=None,
                        help="direct phone string '{k o N ...}' (skips G2P)")
    parser.add_argument("--accents", type=str, default=None,
                        help="accent string e.g. '0[#]0...' matching --phones")
    parser.add_argument("-s", "--speaker_id", type=int, default=0)
    parser.add_argument("-l", "--language", type=str, default="ja",
                        choices=["ja", "en", "zh"])
    parser.add_argument("--use_accent", action="store_true")
    parser.add_argument("--chunk_phones", type=int, default=None,
                        help="unbounded-length mode: split the text at pause "
                             "phones into <=N-phone chunks, synthesize them "
                             "in one batched forward, stitch the audio")
    parser.add_argument("--lexicon", type=str, default=None,
                        help="pinyin lexicon path (zh); defaults to "
                             "<config_dir>/lexicon/pinyin-lexicon-r.txt or cwd")
    args = parser.parse_args(argv)

    from ..core.config import load_config_dir
    from ..infer.synthesis import save_synth_results, synthesize_batch

    cfg = load_config_dir(args.config)
    model, vocoder = load_models(args, cfg)
    ids, accents_ids, raw_text = phone_ids(args, cfg)
    result_path = args.result_path or cfg.train.path.result_path
    meta_dim = cfg.preprocess.speaker_generation.one_hot_dim
    base = (raw_text[:20].replace(" ", "_").replace("{", "").replace("}", "")
            or "utt")
    max_mel_len = args.max_frames or cfg.model.max_seq_len

    if args.chunk_phones:
        from ..audio.wavio import write_wav
        from ..infer.synthesis import synthesize_long

        r = synthesize_long(
            model, ids, accents_ids, speaker_id=args.speaker_id,
            p_control=args.pitch_control, e_control=args.energy_control,
            d_control=args.duration_control, max_phones=args.chunk_phones,
            max_mel_len=max_mel_len, vocoder=vocoder, meta_dim=meta_dim)
        os.makedirs(result_path, exist_ok=True)
        sr = cfg.preprocess.audio.sampling_rate
        print(f"mel_len={r['mel_len']} over {r['n_chunks']} chunks "
              f"({r['mel_len'] * cfg.preprocess.stft.hop_length / sr:.1f}s)")
        if "wav" in r:
            path = os.path.join(result_path, base + ".wav")
            write_wav(path, r["wav"], sr)
        else:
            path = os.path.join(result_path, base + ".npy")
            np.save(path, r["mel"])
        print("wrote", path)
        return

    batch = single_utterance_batch(ids, accents_ids)
    batch.update({
        "ids": [base],
        "raw_texts": [raw_text],
        "speakers": np.array([args.speaker_id], np.int32),
        # zero speaker_meta vector at synthesis (reference synthesize.py:222)
        "speaker_meta": np.zeros((1, meta_dim), np.float32),
    })
    output = synthesize_batch(
        model, batch, p_control=args.pitch_control, e_control=args.energy_control,
        d_control=args.duration_control, max_mel_len=max_mel_len)
    written = save_synth_results(cfg, batch, output, vocoder, result_path)
    print(f"mel_len={int(output.mel_len[0])} -> {result_path}")
    for w in written:
        print("wrote", w)


if __name__ == "__main__":
    main()
