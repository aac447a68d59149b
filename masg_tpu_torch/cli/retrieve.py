# Copied verbatim from masg_tpu/cli/retrieve.py so the port imports nothing of the JAX package.
"""Corpus retrieval/reorganization CLI.

Equivalent of the reference's `python retrieve.py --config C --corpus NAME`
(retrieve.py + retriever/retrieve_{jvs,vctk,transcripts_jsut}.py): reorganize
a downloaded corpus into `raw_data/<speaker>/*.{wav,lab}` and (VCTK) write
speakers.json. Nothing is downloaded — corpora must already be on disk at the
corpus_path configured in preprocess_<CORPUS>.yaml.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from pathlib import Path

import yaml


def retrieve_jvs(config: dict) -> None:
    """JVS: jvs001-100, parallel100 + nonpara30 subsets
    (retriever/retrieve_jvs.py)."""
    corpus_path = config["path"]["corpus_path"]
    raw_path = config["path"]["raw_path"]
    for i in range(1, 101):
        spk = f"jvs{i:0>3d}"
        speaker_path = os.path.join(corpus_path, spk)
        out = os.path.join(raw_path, spk)
        os.makedirs(out, exist_ok=True)
        for target in ("parallel100", "nonpara30"):
            transcript = os.path.join(speaker_path, target, "transcripts_utf8.txt")
            if not os.path.exists(transcript):
                continue
            with open(transcript) as f:
                for line in f:
                    if ":" not in line:
                        continue
                    filename, text = line.split(":", 1)
                    wav = os.path.join(speaker_path, target, "wav24kHz16bit",
                                       filename + ".wav")
                    if os.path.exists(wav):
                        with open(os.path.join(out, filename + ".lab"), "w") as g:
                            g.write(text.strip("\n"))
                        shutil.copyfile(wav, os.path.join(out, filename + ".wav"))


def retrieve_vctk(config: dict) -> None:
    """VCTK: speaker-info.txt -> speakers.json; txt/wav48 pairs; bad-audio
    list skipped; p315 skipped (no transcripts)
    (retriever/retrieve_vctk.py)."""
    corpus_path = Path(config["path"]["corpus_path"])
    preprocessed_path = Path(config["path"]["preprocessed_path"])
    raw_path = Path(config["path"]["raw_path"])

    speakers = {}
    with open(corpus_path / "speaker-info.txt") as f:
        lines = f.readlines()
    for i, line in enumerate(lines[1:]):
        parts = line.split("  ")
        if len(parts) < 3:
            continue
        speaker_id, _, gen = parts[0], parts[1], parts[2]
        speakers["p" + speaker_id.strip()] = [i, gen.strip(), "en"]
    preprocessed_path.mkdir(parents=True, exist_ok=True)
    with open(preprocessed_path / "speakers.json", "w") as f:
        json.dump(speakers, f)

    skip_list = set()
    skip_file = corpus_path.with_name("gomi_wav.list")
    if skip_file.exists():
        with open(skip_file) as f:
            for line in f.readlines()[3:]:
                parts = line.split(" ")
                if len(parts) >= 2:
                    skip_list.add(parts[1].strip().replace(".wav", ""))

    for speaker in speakers:
        if speaker == "p315":  # no transcripts in the corpus
            continue
        text_path = corpus_path / "txt" / speaker
        wav_path = corpus_path / "wav48" / speaker
        if not text_path.exists():
            continue
        out = raw_path / speaker
        out.mkdir(parents=True, exist_ok=True)
        for text in text_path.iterdir():
            filename = text.stem
            if filename in skip_list:
                continue
            with open(text) as f:
                line = f.readline()
            with open((out / filename).with_suffix(".lab"), "w") as f:
                f.write(line.strip("\n"))
            src = (wav_path / filename).with_suffix(".wav")
            if src.exists():
                shutil.copyfile(src, (out / filename).with_suffix(".wav"))


def retrieve_jsut_transcripts(config: dict) -> None:
    """JSUT: */transcript_utf8.txt -> .lab transcript files
    (retriever/retrieve_transcripts_jsut.py)."""
    import glob as g

    corpus_path = config["path"]["corpus_path"]
    raw_path = config["path"]["raw_path"]
    os.makedirs(raw_path, exist_ok=True)
    for transcript in g.glob(os.path.join(corpus_path, "*", "transcript_utf8.txt")):
        with open(transcript) as f:
            for line in f:
                if ":" not in line:
                    continue
                filename, text = line.split(":", 1)
                with open(os.path.join(raw_path, filename + ".lab"), "w") as g2:
                    g2.write(text.strip("\n"))


RETRIEVERS = {
    "jvs": ("preprocess_JVS.yaml", retrieve_jvs),
    "vctk": ("preprocess_VCTK.yaml", retrieve_vctk),
    "jsut": ("preprocess_JSUT.yaml", retrieve_jsut_transcripts),
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True, help="config folder")
    parser.add_argument("--corpus", type=str, required=True,
                        choices=sorted(RETRIEVERS))
    args = parser.parse_args(argv)

    yaml_name, fn = RETRIEVERS[args.corpus.lower()]
    with open(os.path.join(args.config, yaml_name)) as f:
        config = yaml.safe_load(f)
    fn(config)
    print(f"retrieved {args.corpus} -> {config['path']['raw_path']}")


if __name__ == "__main__":
    main()
