"""Dump teacher-forced predicted mels of a trained checkpoint (port of
masg_tpu/cli/dump_mels.py), for vocoder fine-tuning:

    python -m masg_tpu_torch.cli.dump_mels -c config/JSUT --restore_step 300000 \\
        --out out/predicted_mel [--split train.txt val.txt] [--corpus JSUT]
        [--ganlike] [--batch_size N] [--device cuda|cpu] [--no-use_flash]

then:

    python -m masg_tpu_torch.cli.train_vocoder --wav_dir raw_data/JSUT \\
        --mel_dir out/predicted_mel --warm_start_generator g_universal ...

The forward is teacher-forced (ground-truth durations, pitch and energy) in
eval mode, attention through kernel K1 on the card, so every mel is
frame-aligned with its audio: frame i covers samples [i*hop, (i+1)*hop).
Files are `{speaker}-mel-{basename}.npy`, the preprocessed ground-truth
mels' names, trimmed at each utterance's mel length. `--ganlike` reads the
FastSpeech2 half of a `cli.train_ganlike` checkpoint.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--restore_step", type=int, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--corpus", type=str, nargs="*", default=None)
    parser.add_argument("--split", type=str, nargs="*", default=["train.txt", "val.txt"])
    parser.add_argument("--ganlike", action="store_true",
                        help="checkpoint came from train_ganlike")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--use_flash", action=argparse.BooleanOptionalAction, default=True,
                        help="attention through the flash kernel K1")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..core.config import load_config_dir
    from ..data.dataset import Dataset
    from ..device import resolve_device
    from ..train.loop import build_corpus_dict, build_experiment
    from ..train.step import _forward, batch_to_device

    device = resolve_device(args.device)
    cfg = load_config_dir(args.config)
    trainer = build_experiment(cfg, corpora=args.corpus, ganlike=args.ganlike,
                               restore_step=args.restore_step, device=device,
                               use_flash=args.use_flash)
    model = trainer.state.fs2
    dtype = next(model.parameters()).dtype
    bs = args.batch_size or cfg.train.optimizer.batch_size

    os.makedirs(args.out, exist_ok=True)
    n_written = 0
    for split in args.split:
        for corpus in args.corpus or list(cfg.corpora):
            ds = Dataset(split, build_corpus_dict(cfg, corpus), batch_size=bs, sort=False,
                         drop_last=False, text_bucket=16, mel_bucket=64)
            # length-sorted chunks bound the padding
            order = np.argsort([-len(t.split()) for t in ds.text])
            for i in range(0, len(order), bs):
                data = [ds[int(j)] for j in order[i:i + bs]]
                batch = batch_to_device(ds.reprocess(data, list(range(len(data)))),
                                        device, dtype)
                with torch.inference_mode():
                    out = _forward(model, batch, train=False)
                    mels = out.postnet_mel.float().cpu().numpy()
                    mel_lens = out.mel_len.cpu().numpy()
                for j, d in enumerate(data):
                    np.save(os.path.join(args.out, f"{d['speaker_name']}-mel-{d['id']}.npy"),
                            np.asarray(mels[j, : int(mel_lens[j])], np.float32))
                    n_written += 1
            print(f"{corpus}/{split}: done ({n_written} total)")
    print(f"wrote {n_written} predicted mels to {args.out}")
    return n_written


if __name__ == "__main__":
    main()
