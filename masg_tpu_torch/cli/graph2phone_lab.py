# Copied from masg_tpu/cli/graph2phone_lab.py (its last docstring line names this package's prepare_alignments) so the port imports nothing of the JAX package.
"""Grapheme -> phone label conversion for HTS alignment prep.

Equivalent of the reference's graph2phone_lab.py / the espeak leg of
prepare_align_hts.py: for every grapheme transcript .lab under raw_path,
write an espeak-ng-IPA phone-list .lab under lab_path/<speaker>/ wrapped in
sil ... sil (the input format the phoneme_alignment_hts HTK recipe consumes).

The HTK forced-alignment training itself (prepare_align_hts.py:61-80 calling
phoneme_alignment_hts/scripts + perl/HTK) is an external toolchain the
reference also shells out to; align the emitted labs with your HTK/MFA setup,
then feed the result to masg_tpu_torch.cli.prepare_alignments.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
from pathlib import Path

import yaml


def graphemes_to_phone_lab(text: str, lang: str) -> list:
    """One transcript line -> espeak IPA phones, sil/pau framed
    (reference graph2phone_lab.py:32-50)."""
    if shutil.which("espeak-ng") is None:
        raise RuntimeError("graph2phone_lab needs the espeak-ng binary")
    cmd = ["espeak-ng", "--ipa", "--sep", "-v", lang, "-q", '"{}"'.format(text)]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    res2 = ["sil"]
    for line in iter(p.stdout.readline, b""):
        # strip commas (reference graph2phone_lab.py:46) and both stress marks
        cleaned = (line.decode("utf8").strip()
                   .replace(",", "").replace("ˌ", "").replace("ˈ", ""))
        res2.extend(re.split(" +", cleaned))
        res2.append("pau")
    p.stdout.close()
    p.wait()
    res2 = res2[:-3] + ["sil"]
    return [r for r in res2 if r != "_:"]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--corpus", type=str, required=True)
    parser.add_argument("--speaker", type=str, default=None)
    args = parser.parse_args(argv)

    with open(os.path.join(args.config, f"preprocess_{args.corpus}.yaml")) as f:
        config = yaml.safe_load(f)
    raw_path = Path(config["path"]["raw_path"])
    lab_path = Path(config["path"]["lab_path"])
    lang = config["text"]["language"]
    lab_path.mkdir(parents=True, exist_ok=True)

    for folder in sorted(raw_path.iterdir()):
        if args.speaker is not None and folder.name != args.speaker:
            continue
        out = lab_path / folder.name
        out.mkdir(exist_ok=True)
        for lab in sorted(folder.glob("*.lab")):
            with open(lab) as f:
                line = f.readline()
            phones = graphemes_to_phone_lab(line, lang)
            with open(out / lab.name, "w") as f:
                f.write("\n".join(phones))
        print(f"{folder.name}: phone labs -> {out}")


if __name__ == "__main__":
    main()
