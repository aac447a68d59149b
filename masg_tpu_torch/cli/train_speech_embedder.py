"""GE2E speaker-encoder training CLI (port of masg_tpu/cli/train_speech_embedder.py).

    python -m masg_tpu_torch.cli.train_speech_embedder --data_path <chunks>
        --out_dir <dir> [--datasets JVS VCTK] [-N 32] [-M 10] [--epochs 2400]
        [--batches_per_epoch B] [--lr 1e-3] [--da_startpoint 0.0] [--wo_ge2e]
        [--checkpoint_interval 200] [--seed 0] [--device cuda|cpu]
        [--n_devices N] [--multihost]

The reference submodule's `python train_speech_embedder.py`
(Multilingual-.../train_speech_embedder.py:115-248), configured by flags.
`--data_path` holds `{dataset}_{spkr}_{gender}_{lang}.npy` chunk archives
(`preprocessor.ge2e_preprocess.build_ge2e_corpus`). Checkpoints are the
reference's torch format, `<out_dir>/final_epoch_<epochs>.pth` last: a
`discriminator_path` for `cli.train --use_clf` and `cli.train_ganlike` in
both packages. `--n_devices N` trains data-parallel over N processes (the
reference's NCCL DDP, masg_tpu's mesh): the N x M chunk batch splits by
rows over `data_parallel_size(N * M, n_devices)` of them; `--multihost`
joins the group the environment names (see `cli.train`).
"""

from __future__ import annotations

import argparse

from ..parallel.mesh import add_parallel_flags, launch_data_parallel


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True,
                        help="dir of {dataset}_{spkr}_{gender}_{lang}.npy chunks")
    parser.add_argument("--datasets", type=str, nargs="+", default=["JVS", "VCTK"])
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("-N", "--n_speakers", type=int, default=32)
    parser.add_argument("-M", "--m_utts", type=int, default=10)
    parser.add_argument("--epochs", type=int, default=2400)
    parser.add_argument("--batches_per_epoch", type=int, default=None)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--da_startpoint", type=float, default=0.0)
    parser.add_argument("--wo_ge2e", action="store_true",
                        help="reproduce the reference snapshot's woGE2E ablation")
    parser.add_argument("--checkpoint_interval", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    add_parallel_flags(parser)
    args = parser.parse_args(argv)
    return launch_data_parallel(run, args, args.n_speakers * args.m_utts)


def run(args, device):
    """Train on `device` (this process's share when a process group is joined)."""
    from ..train.ge2e import train_speaker_encoder

    return train_speaker_encoder(
        data_path=args.data_path,
        datasets=args.datasets,
        out_dir=args.out_dir,
        n_speakers=args.n_speakers,
        m_utts=args.m_utts,
        epochs=args.epochs,
        batches_per_epoch=args.batches_per_epoch,
        lr=args.lr,
        da_startpoint=args.da_startpoint,
        use_ge2e_backward=not args.wo_ge2e,
        checkpoint_interval=args.checkpoint_interval,
        seed=args.seed,
        device=device,
    )


if __name__ == "__main__":
    main()
