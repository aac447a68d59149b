# Copied verbatim from masg_tpu/preprocessor/textgrid.py so the port imports nothing of the JAX package.
"""Minimal Praat TextGrid parser (the reference uses the `tgt` package,
preprocessor.py:177; this image has none, so we parse the format directly).

Supports long ("ooTextFile") and short formats, IntervalTiers only — which is
all MFA/Julius alignment outputs use.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval] = field(default_factory=list)

    # tgt-compatible accessor used by the alignment code
    @property
    def _objects(self):
        return self.intervals


@dataclass
class TextGrid:
    tiers: List[Tier] = field(default_factory=list)

    def get_tier_by_name(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r}; have {[t.name for t in self.tiers]}")


_NUM = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")
_STR = re.compile(r'"((?:[^"]|"")*)"')


def read_textgrid(path: str) -> TextGrid:
    with open(path, encoding="utf-8") as f:
        content = f.read()
    return parse_textgrid(content)


def parse_textgrid(content: str) -> TextGrid:
    lines = content.splitlines()
    if not any("ooTextFile" in l for l in lines[:3]):
        raise ValueError("not a Praat TextGrid file")

    # tokenize: every quoted string or bare number in order, tracking tier
    # boundaries via 'IntervalTier' markers works for both long/short formats
    tokens: List[object] = []
    for line in lines[3:]:
        # drop long-format list indices ('item [1]:', 'intervals [2]:') so
        # they don't inject spurious number tokens
        line = re.sub(r"\[\s*\d*\s*\]", "", line)
        # strip long-format keys ('xmin = 1.23') down to their values
        for m in re.finditer(r'"(?:[^"]|"")*"|[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?', line):
            tok = m.group(0)
            if tok.startswith('"'):
                tokens.append(tok[1:-1].replace('""', '"'))
            else:
                tokens.append(float(tok))

    # layout: xmin xmax [exists-flag] n_tiers then per tier:
    #   "IntervalTier" name xmin xmax n_intervals (xmin xmax text)*
    tg = TextGrid()
    i = 0
    # skip until the first "IntervalTier"/"TextTier" token
    while i < len(tokens) and tokens[i] not in ("IntervalTier", "TextTier"):
        i += 1
    while i < len(tokens):
        kind = tokens[i]
        i += 1
        if kind == "TextTier":
            # point tier: name xmin xmax n (time mark)*
            name = str(tokens[i]); i += 3
            n = int(tokens[i]); i += 1
            i += 2 * n
            tg.tiers.append(Tier(name=name))
            continue
        if kind != "IntervalTier":
            continue
        name = str(tokens[i]); i += 1
        i += 2  # tier xmin xmax
        n = int(tokens[i]); i += 1
        tier = Tier(name=name)
        for _ in range(n):
            xmin = float(tokens[i]); xmax = float(tokens[i + 1])
            text = str(tokens[i + 2]); i += 3
            tier.intervals.append(Interval(xmin, xmax, text))
        tg.tiers.append(tier)
    return tg


def write_textgrid(path: str, tg: TextGrid, xmin: float = 0.0, xmax: Optional[float] = None) -> None:
    """Write long-format TextGrid (used by the synthetic corpus fixture and
    the alignment-prep tools)."""
    if xmax is None:
        xmax = max((t.intervals[-1].end_time for t in tg.tiers if t.intervals), default=0.0)
    out = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {xmin}",
        f"xmax = {xmax}",
        "tiers? <exists>",
        f"size = {len(tg.tiers)}",
        "item []:",
    ]
    for ti, tier in enumerate(tg.tiers, 1):
        out += [
            f"    item [{ti}]:",
            '        class = "IntervalTier"',
            f'        name = "{tier.name}"',
            f"        xmin = {xmin}",
            f"        xmax = {xmax}",
            f"        intervals: size = {len(tier.intervals)}",
        ]
        for ii, iv in enumerate(tier.intervals, 1):
            out += [
                f"        intervals [{ii}]:",
                f"            xmin = {iv.start_time}",
                f"            xmax = {iv.end_time}",
                f'            text = "{iv.text}"',
            ]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")
