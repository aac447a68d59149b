# Copied verbatim from masg_tpu/preprocessor/alignments.py so the port imports nothing of the JAX package.
"""Alignment prep: Julius/HTS .lab label files -> TextGrids + accent files.

Reference: convert_label.py / convert_label_jvs.py (Segment, mora merging,
read_lab with 100ns units), prepare_tg_accent_{jsut,jvs}.py (lab glob ->
TextGrid/<spk>/ + accent/ via pp_symbols), prepare_tg_hts.py /
prepare_align_hts.py (HTS full-context variants).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from ..text.g2p import openjtalk2julius, pp_symbols
from .textgrid import Interval, TextGrid, Tier, write_textgrid

_VOWELS = ["a", "i", "u", "e", "o", "a:", "i:", "u:", "e:", "o:"]
_CONSONANTS = ["w", "r", "t", "y", "p", "s", "d", "f", "g", "h", "j",
               "k", "z", "c", "b", "n", "m"]


@dataclass
class Segment:
    """A unit of speech (phoneme or mora); reference convert_label.py:13-48."""

    t_start: float
    t_end: float
    label: str

    def merged(self, other: "Segment") -> "Segment":
        return Segment(self.t_start, other.t_end, self.label + other.label)

    def can_follow(self, other: "Segment") -> bool:
        only_consonants = lambda x: all(c in _CONSONANTS for c in x)
        if only_consonants(other.label) and self.label in _VOWELS:
            return True
        if only_consonants(other.label) and only_consonants(self.label):
            return True
        return False


def read_full_context_lab(path: str, times_in_seconds: bool = False) -> List[Segment]:
    """HTS full-context .lab (phone in -p+ context) -> phone segments.

    Times are 100ns units (reference convert_label.py:60-76, /10e6) for
    JSUT-style labs, or already seconds for JVS-style labs
    (convert_label_jvs.py:75: no division)."""
    scale = 1.0 if times_in_seconds else 1e7
    segments = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            phone = re.search(r"\-(.*?)\+", parts[2])
            label = openjtalk2julius(phone.group(1)) if phone else parts[2]
            segments.append(
                Segment(float(parts[0]) / scale, float(parts[1]) / scale, label)
            )
    return segments


def decode_octal_escapes(s: str) -> str:
    """Decode `\\ooo` octal byte escapes into UTF-8 text (Julius segmentation
    kit writes multibyte mora labels this way; reference
    prepare_tg_hts.py:58-74 decodes them inside its openjtalk2julius)."""
    out = bytearray()
    i = 0
    octal = set("01234567")
    while i < len(s):
        if s[i] == "\\" and i + 4 <= len(s) and set(s[i + 1: i + 4]) <= octal:
            out.append(int(s[i + 1: i + 4], 8))
            i += 4
        else:
            out.extend(s[i].encode())
            i += 1
    return out.decode("utf-8", errors="replace")


def read_plain_lab(path: str) -> List[Segment]:
    """Plain `start end phone` .lab with times in seconds (Julius segmentation
    kit / prepare_tg_hts.py:83-99 output without -p+ context; labels may
    carry octal byte escapes)."""
    segments = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            label = openjtalk2julius(decode_octal_escapes(parts[2]))
            segments.append(Segment(float(parts[0]), float(parts[1]), label))
    return segments


def by_moras(segments: List[Segment]) -> List[Segment]:
    """Merge phone segments into moras (reference convert_label.py:86-106)."""
    out: List[Segment] = []
    cur: Optional[Segment] = None
    for seg in segments:
        if cur is None:
            cur = seg
        elif seg.can_follow(cur):
            cur = cur.merged(seg)
        else:
            out.append(cur)
            cur = seg
    if cur is not None:
        out.append(cur)
    return out


def segments_to_textgrid(segments: List[Segment], path: str,
                         tier_name: str = "phones") -> None:
    """silB/silE labels become empty text (treated as silence by the
    alignment reader; reference convert_label.py:43-48)."""
    intervals = [
        Interval(s.t_start, s.t_end, "" if s.label in ("silB", "silE") else s.label)
        for s in segments
    ]
    tg = TextGrid(tiers=[Tier(name=tier_name, intervals=intervals)])
    xmax = segments[-1].t_end if segments else 0.0
    write_textgrid(path, tg, 0.0, xmax)


def prepare_alignments(
    lab_dir: str,
    output_dir: str,
    speaker: str,
    with_accent: bool = False,
    full_context: bool = True,
    times_in_seconds: bool = False,
) -> int:
    """Glob **/*.lab under lab_dir -> TextGrid/<speaker>/ (+ accent/ when
    requested). Reference prepare_tg_accent_jsut.py:69-101. Returns the number
    of files converted."""
    tg_dir = Path(output_dir) / "TextGrid" / speaker
    tg_dir.mkdir(parents=True, exist_ok=True)
    ac_dir = Path(output_dir) / "accent"
    if with_accent:
        ac_dir.mkdir(parents=True, exist_ok=True)

    n = 0
    for lab_file in sorted(Path(lab_dir).glob("**/*.lab")):
        if with_accent:
            with open(lab_file) as f:
                lines = [l for l in f.readlines() if l.strip()]
            _, accent = pp_symbols(lines)
            with open(ac_dir / lab_file.with_suffix(".accent").name, "w") as f:
                f.write("".join(accent))
        segments = (
            read_full_context_lab(str(lab_file), times_in_seconds=times_in_seconds)
            if full_context
            else read_plain_lab(str(lab_file))
        )
        segments_to_textgrid(segments, str(tg_dir / lab_file.with_suffix(".TextGrid").name))
        n += 1
    return n
