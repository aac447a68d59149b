"""Shared arithmetic of the per-layer readers in `metrics/`. Each reader
returns None where its run has nothing to read, and the harness then leaves
its metric out of the result."""

from __future__ import annotations

from typing import Optional, Sequence

from portbench import work
from portbench.harness import Record, busy_and_gaps


def span_ms(rec: Record, name: str) -> Optional[float]:
    """The window's total of the host spans called `name`, in ms."""
    d = [e - s for n, s, e in rec.spans if n == name]
    return sum(d) / 1e6 if d else None


def roofline(rec: Record, launches_key: str, matches: Sequence[str]) -> Optional[float]:
    """100 x the summed bound of the launches listed under `launches_key`
    ((ops, bytes) each) over the summed device time of the kernels whose
    name holds one of `matches`; None unless the trace holds exactly one
    kernel per listed launch."""
    launches = rec.work.get(launches_key)
    kern = [d for n, _, d in rec.events if any(m in n for m in matches)]
    if not launches or len(kern) != len(launches):
        return None
    bound = sum(work.bound_s(ops, nb, rec.dtype) for ops, nb in launches)
    return 100.0 * bound / (sum(kern) / 1e9)


def mfu(rec: Record) -> Optional[float]:
    """100 x the window's useful model flops over (window seconds x peak)."""
    flops = rec.work.get("useful_flops")
    if not flops or not rec.window_s:
        return None
    return 100.0 * flops / (rec.window_s * work.PEAK_FLOPS[rec.dtype])


def idle_share(rec: Record) -> Optional[float]:
    """100 x the share of the traced window in which no kernel ran."""
    if not rec.events or not rec.trace_window:
        return None
    busy, _ = busy_and_gaps(rec)
    lo, hi = rec.trace_window
    return 100.0 * (1.0 - busy / ((hi - lo) / 1e9))
