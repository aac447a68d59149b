"""Shared arithmetic of the readers of the program's own spans and counters
(`masg_tpu_torch.utils.profiling`). The program records them while a
profiler session is open, so in a `--trace 1` run, from the Tracer's entry
to its exit. The readers keep the spans of the main thread, the one that
drives the cell, that lie inside the traced window. Each returns None where
the program recorded nothing: an untraced run, or a program older than
these spans."""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench.harness import Record, busy_and_gaps


def _profiling():
    """The program's tracing module, or None where it has no spans."""
    try:
        from masg_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "counters") else None


def program_spans(rec: Record) -> Optional[list]:
    """The program's spans of the main thread inside `rec.trace_window`."""
    prof = _profiling()
    if prof is None or not rec.trace_window:
        return None
    lo, hi = rec.trace_window
    main = threading.main_thread().ident
    return [s for s in prof.spans() if s.thread == main and lo <= s.start_ns and s.end_ns <= hi]


def program_counters(rec: Record) -> Optional[Dict[str, float]]:
    """The program's counters of a traced run (the totals over the Tracer's
    session, whose only program calls are the window's)."""
    prof = _profiling()
    if prof is None or not rec.trace_window:
        return None
    return prof.counters()


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap_ns(xs: Sequence[Tuple[int, int]], ys: Sequence[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_span_ms(rec: Record, name: str) -> Optional[float]:
    """Device-idle time inside the program's spans called `name`, in ms: the
    overlap of the window's idle gaps (`harness.busy_and_gaps`) with the
    union of those spans' intervals."""
    spans = program_spans(rec)
    own = _union((s.start_ns, s.end_ns) for s in spans or () if s.name == name)
    if not own or not rec.events:
        return None
    _, gaps = busy_and_gaps(rec)
    return _overlap_ns(gaps, own) / 1e6


def stream_ms(rec: Record, name: str, less_child: Optional[str] = None) -> Optional[float]:
    """The summed stream time of the program's spans called `name`, less
    that of their children called `less_child`, in ms; None where a span
    took no stream time."""
    spans = program_spans(rec) or []
    own = [s for s in spans if s.name == name]
    ids = {s.id for s in own}
    kids = [s for s in spans if s.name == less_child and s.parent in ids] if less_child else []
    if not own or any(s.stream_ms is None for s in own + kids):
        return None
    return sum(s.stream_ms for s in own) - sum(s.stream_ms for s in kids)


def vocoder_pad_share(rec: Record) -> Optional[float]:
    """100 x the share of the samples the vocoder made that the trim left
    out (the padding past each row's length)."""
    c = program_counters(rec) or {}
    made = c.get("vocoder.samples")
    if not made:
        return None
    return 100.0 * (1.0 - c.get("vocoder.useful_samples", 0) / made)
