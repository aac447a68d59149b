# Copied verbatim from masg_tpu/cli/prepare_alignments.py so the port imports nothing of the JAX package.
"""Alignment prep CLI.

Equivalent of the reference's `python prepare_tg_accent_jsut.py <lab> <output>
<speaker> [--with_accent]` / prepare_tg_accent_jvs.py / prepare_tg_hts.py:
convert Julius/HTS .lab files into TextGrids (+ accent files).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("lab", type=str, help="dir searched recursively for .lab files")
    parser.add_argument("output", type=str, help="output root (TextGrid/ + accent/)")
    parser.add_argument("speaker", type=str)
    parser.add_argument("--with_accent", action="store_true")
    parser.add_argument("--plain", action="store_true",
                        help="labs are plain `start end phone` (seconds), not "
                             "HTS full-context 100ns labels")
    parser.add_argument("--seconds", action="store_true",
                        help="full-context labs carry times in seconds "
                             "(JVS-style, reference convert_label_jvs.py:75) "
                             "instead of 100ns units")
    args = parser.parse_args(argv)

    from ..preprocessor.alignments import prepare_alignments

    n = prepare_alignments(
        args.lab, args.output, args.speaker,
        with_accent=args.with_accent, full_context=not args.plain,
        times_in_seconds=args.seconds,
    )
    print(f"converted {n} lab files -> {args.output}/TextGrid/{args.speaker}")


if __name__ == "__main__":
    main()
