# Copied verbatim from masg_tpu/cli/jvs_speakers.py so the port imports nothing of the JAX package.
"""Build JVS speakers.json from the corpus's gender_f0range.txt.

Equivalent of the reference's jvs_speaker.py (which hardcodes an absolute
path; here it's a flag).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gender_f0range", type=str, required=True,
                        help="path to jvs .../gender_f0range.txt")
    parser.add_argument("-o", "--output", type=str, default="speakers.json")
    args = parser.parse_args(argv)

    speakers = {}
    with open(args.gender_f0range) as f:
        lines = f.readlines()
    # ids from a counter over ACCEPTED lines only: a skipped malformed line
    # must not leave a gap (ids index the nn.Embed table)
    idx = 0
    for line in lines[1:]:
        parts = line.split(" ")
        if len(parts) < 2:
            continue
        spk, gen = parts[0], parts[1]
        speakers[spk] = [idx, gen, "ja"]
        idx += 1

    with open(args.output, "w") as f:
        json.dump(speakers, f)
    print(f"{len(speakers)} JVS speakers -> {args.output}")


if __name__ == "__main__":
    main()
