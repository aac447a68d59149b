"""The port's corpus CLIs (`retrieve`, `gather`, `make_config`,
`prepare_alignments` with `preprocessor/alignments.py`, `graph2phone_lab`,
`jvs_speakers`) against masg_tpu's: each pair runs on the same tiny
synthetic inputs in its own output directory, and the outputs must be
byte-identical (the reorganized tree, speakers.json, TextGrids and accent
files, the merged stats.json, the YAMLs). Host-only: no device is involved.
"""

import importlib
import json
import os
import shutil

import numpy as np
import pytest
import yaml
import torch_port_support  # noqa: F401  (the port tests' thread count)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def cli(package, name):
    return importlib.import_module(f"{package}.cli.{name}").main


def tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_same_tree(got, want):
    g, w = tree(got), tree(want)
    assert g.keys() == w.keys() and len(w) > 0
    for k in w:
        assert g[k] == w[k], k


def test_prepare_alignments_matches(tmp_path):
    """Full-context labs with accents (100 ns units), the same in seconds, and
    plain labs with an octal-escaped mora: TextGrid/<speaker>/ and accent/."""
    labs = tmp_path / "labs"
    (labs / "sub").mkdir(parents=True)
    shutil.copy(os.path.join(DATA, "konnichiwa_full.lab"), labs / "a.lab")
    shutil.copy(os.path.join(DATA, "konnichiwa_full.lab"), labs / "sub" / "b.lab")
    secs = tmp_path / "secs"
    secs.mkdir()
    with open(os.path.join(DATA, "konnichiwa_full.lab")) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    (secs / "c.lab").write_text("".join(f"{int(a) / 1e7} {int(b) / 1e7} {c}\n"
                                        for a, b, c in lines))
    plain = tmp_path / "plain"
    plain.mkdir()
    (plain / "d.lab").write_text("0.0 0.25 silB\n0.25 0.4 k\n0.4 0.5 o\n"
                                 "0.5 0.7 \\343\\201\\202\n0.7 0.9 N\n0.9 1.1 silE\n")
    for pkg in ("masg_tpu", "masg_tpu_torch"):
        main = cli(pkg, "prepare_alignments")
        out = str(tmp_path / pkg)
        main([str(labs), out, "spk", "--with_accent"])
        main([str(secs), out, "spk_s", "--seconds"])
        main([str(plain), out, "spk_p", "--plain"])
    assert_same_tree(tmp_path / "masg_tpu_torch", tmp_path / "masg_tpu")
    assert (tmp_path / "masg_tpu" / "accent" / "b.accent").exists()


def _corpus_yaml(cfg_dir, name, corpus, raw, pre, lab=""):
    body = {"dataset": name, "path": {"corpus_path": str(corpus), "lexicon_path": "",
                                      "raw_path": str(raw), "preprocessed_path": str(pre),
                                      "lab_path": str(lab)},
            "text": {"text_cleaners": [], "language": "ja" if name != "VCTK" else "en"},
            "accent": {"use_accent": False}}
    (cfg_dir / f"preprocess_{name}.yaml").write_text(yaml.safe_dump(body))


def _write_corpora(root):
    """Tiny JVS, VCTK and JSUT downloads in their published layouts."""
    rng = np.random.default_rng(0)
    wav = lambda: rng.integers(0, 255, 64, dtype=np.uint8).tobytes()  # noqa: E731
    jvs = root / "jvs"
    for spk in ("jvs001", "jvs002"):
        for target in ("parallel100", "nonpara30"):
            d = jvs / spk / target
            (d / "wav24kHz16bit").mkdir(parents=True)
            names = [f"{target}_{i:03d}" for i in range(2)]
            (d / "transcripts_utf8.txt").write_text(
                "".join(f"{n}:こんにちは{i}\n" for i, n in enumerate(names)) + "bad line\n")
            for n in names[:1]:  # one transcript line without its wav
                (d / "wav24kHz16bit" / f"{n}.wav").write_bytes(wav())
    vctk = root / "vctk" / "VCTK-Corpus"
    (vctk / "txt").mkdir(parents=True)
    (vctk / "speaker-info.txt").write_text(
        "ID  AGE  GENDER  ACCENTS  REGION\n225  23  F    English    Southern  England\n"
        "226  22  M    English    Surrey\n315  24  M    American  Connecticut\n")
    for spk in ("p225", "p226", "p315"):
        (vctk / "txt" / spk).mkdir()
        (vctk / "wav48" / spk).mkdir(parents=True)
        for i in range(3):
            (vctk / "txt" / spk / f"{spk}_{i:03d}.txt").write_text(f"Please call {spk}.\n")
            (vctk / "wav48" / spk / f"{spk}_{i:03d}.wav").write_bytes(wav())
    (root / "vctk" / "gomi_wav.list").write_text("h1\nh2\nh3\n1 p225_001.wav\n")
    jsut = root / "jsut"
    for sub in ("basic5000", "onomatopee300"):
        (jsut / sub).mkdir(parents=True)
        (jsut / sub / "transcript_utf8.txt").write_text(f"{sub.upper()}_0001:水をマレーシアから\n")
    return jvs, vctk, jsut


def test_retrieve_matches(tmp_path):
    """`retrieve --corpus jvs|vctk|jsut`: the reorganized raw_data trees and
    VCTK's speakers.json."""
    jvs, vctk, jsut = _write_corpora(tmp_path / "downloads")
    for pkg in ("masg_tpu", "masg_tpu_torch"):
        cfg = tmp_path / pkg / "cfg"
        cfg.mkdir(parents=True)
        out = tmp_path / pkg / "out"
        for name, corpus in (("JVS", jvs), ("VCTK", vctk), ("JSUT", jsut)):
            _corpus_yaml(cfg, name, corpus, out / "raw" / name, out / "pre" / name)
            cli(pkg, "retrieve")(["--config", str(cfg), "--corpus", name.lower()])
    assert_same_tree(tmp_path / "masg_tpu_torch" / "out", tmp_path / "masg_tpu" / "out")
    spk = json.loads((tmp_path / "masg_tpu_torch" / "out" / "pre" / "VCTK" /
                      "speakers.json").read_text())
    assert sorted(spk) == ["p225", "p226", "p315"]
    assert not (tmp_path / "masg_tpu" / "out" / "raw" / "VCTK" / "p225" /
                "p225_001.wav").exists()  # listed as bad audio


def test_gather_matches(tmp_path):
    """`gather` over two preprocessed corpora: the merged speakers.json and
    the normalized stats.json in the config dir."""
    from masg_tpu_torch.data.synthetic import write_config_dir

    rng = np.random.default_rng(1)
    pres = []
    for c, n_spk in (("A", 2), ("B", 3)):
        pre = tmp_path / "pre" / c
        for kind in ("pitch", "energy"):
            (pre / kind).mkdir(parents=True)
            for i in range(4):
                np.save(pre / kind / f"{c}-{kind}-{i}.npy",
                        rng.normal(3.0 if kind == "pitch" else 1.0, 2.0, size=7 + i))
        (pre / "speakers.json").write_text(json.dumps(
            {f"{c}{s}": [s, "MF"[s % 2], "ja" if c == "A" else "en"] for s in range(n_spk)}))
        pres.append(pre)
    for pkg in ("masg_tpu", "masg_tpu_torch"):
        cfg = tmp_path / pkg / "cfg"
        write_config_dir(str(cfg), str(pres[0]), str(tmp_path / pkg / "out"), dataset="A")
        _corpus_yaml(cfg, "B", "", "", pres[1])
        for f in ("stats.json", "speakers.json"):
            if (cfg / f).exists():
                (cfg / f).unlink()
        cli(pkg, "gather")(["--config", str(cfg)])
    for f in ("stats.json", "speakers.json"):
        want = (tmp_path / "masg_tpu" / "cfg" / f).read_bytes()
        assert (tmp_path / "masg_tpu_torch" / "cfg" / f).read_bytes() == want, f
    assert len(json.loads(want)) == 5


@pytest.mark.parametrize("preset,extra", [
    ("JSUT", ["--use_jdit"]), ("JVS", []), ("JVS-VCTK", ["--total_step", "123"]),
    ("JVS-VCTK-langemb", ["--lambda", "0.5", "--discriminator_path", "/d/ge2e.pth"])])
def test_make_config_matches(tmp_path, preset, extra):
    """`make_config <preset>`: every YAML of the config dir, `--use_jdit`
    among the flags; the port's config loader reads the result."""
    from masg_tpu_torch.core.config import load_config_dir

    for pkg in ("masg_tpu", "masg_tpu_torch"):
        cli(pkg, "make_config")([preset, "-o", str(tmp_path / pkg / "exp"),
                                 "--data_root", "/corpora", *extra])
    assert_same_tree(tmp_path / "masg_tpu_torch", tmp_path / "masg_tpu")
    cfg = load_config_dir(str(tmp_path / "masg_tpu_torch" / "exp"))
    assert cfg.model.jdit.use_jdit == ("--use_jdit" in extra)


def test_jvs_speakers_matches(tmp_path):
    """`jvs_speakers`: ids count accepted lines only (a malformed line leaves
    no gap)."""
    src = tmp_path / "gender_f0range.txt"
    src.write_text("speaker Male_or_Female minf0 maxf0\njvs001 M 70 300\n"
                   "broken\njvs002 F 150 500\njvs003 M 60 280\n")
    for pkg in ("masg_tpu", "masg_tpu_torch"):
        cli(pkg, "jvs_speakers")(["--gender_f0range", str(src), "-o",
                                  str(tmp_path / f"{pkg}.json")])
    want = (tmp_path / "masg_tpu.json").read_bytes()
    assert (tmp_path / "masg_tpu_torch.json").read_bytes() == want
    assert json.loads(want)["jvs003"] == [2, "M", "ja"]


FAKE_ESPEAK = """#!/bin/sh
# stands in for espeak-ng --ipa --sep -v <lang> -q "<text>": two IPA lines
echo "h_ə l_ˈoʊ, w_ˈɜː_l_d"
echo "ð_ɪ s _: ˌɪ_z_ $3"
"""


def _graph2phone_inputs(root):
    raw = root / "raw"
    for spk in ("p225", "p226"):
        (raw / spk).mkdir(parents=True)
        for i in range(2):
            (raw / spk / f"{spk}_{i:03d}.lab").write_text(f"Hello world {i}.")
    return raw


def _run_graph2phone(tmp_path, raw, speaker=None):
    for pkg in ("masg_tpu", "masg_tpu_torch"):
        cfg = tmp_path / pkg / "cfg"
        cfg.mkdir(parents=True, exist_ok=True)
        _corpus_yaml(cfg, "VCTK", "", raw, "", lab=tmp_path / pkg / "lab")
        args = ["--config", str(cfg), "--corpus", "VCTK"]
        cli(pkg, "graph2phone_lab")(args + (["--speaker", speaker] if speaker else []))


def test_graph2phone_lab_matches_with_a_stand_in_espeak(tmp_path, monkeypatch):
    """`graph2phone_lab` through the same stand-in `espeak-ng` (a script on
    PATH that prints fixed IPA lines): the sil/pau-framed phone labs."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "espeak-ng").write_text(FAKE_ESPEAK)
    (bin_dir / "espeak-ng").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    raw = _graph2phone_inputs(tmp_path)
    _run_graph2phone(tmp_path, raw)
    _run_graph2phone(tmp_path / "one", raw, speaker="p226")
    for root in (tmp_path, tmp_path / "one"):
        assert_same_tree(root / "masg_tpu_torch" / "lab", root / "masg_tpu" / "lab")
    lab = (tmp_path / "masg_tpu_torch" / "lab" / "p225" / "p225_000.lab").read_text()
    assert lab.startswith("sil\n") and lab.endswith("\nsil") and "pau" in lab
    assert not (tmp_path / "one" / "masg_tpu_torch" / "lab" / "p225").exists()


def test_graph2phone_lab_raises_without_espeak(tmp_path, monkeypatch):
    """Without `espeak-ng` on PATH both CLIs raise the same RuntimeError."""
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    raw = _graph2phone_inputs(tmp_path)
    for pkg in ("masg_tpu", "masg_tpu_torch"):
        cfg = tmp_path / pkg / "cfg"
        cfg.mkdir(parents=True)
        _corpus_yaml(cfg, "VCTK", "", raw, "", lab=tmp_path / pkg / "lab")
        with pytest.raises(RuntimeError, match="espeak-ng"):
            cli(pkg, "graph2phone_lab")(["--config", str(cfg), "--corpus", "VCTK"])


def test_graph2phone_lab_matches_with_espeak(tmp_path):
    """With the real `espeak-ng` binary, where it is installed."""
    if shutil.which("espeak-ng") is None:
        pytest.skip("espeak-ng is not installed here")
    _run_graph2phone(tmp_path, _graph2phone_inputs(tmp_path))
    assert_same_tree(tmp_path / "masg_tpu_torch" / "lab", tmp_path / "masg_tpu" / "lab")
