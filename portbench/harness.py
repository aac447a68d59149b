"""What every cell shares: finding its files by name, the device checks, the
weights made from the seed, the host spans and counters of a run, the
device trace, the per-layer readers and the result line.

A cell is `workloads/<name>.json`; it names its configuration
(`configs/<config>.json`) and its driver (`drivers/<driver>.py`, whose
`run(ctx)` drives the program and returns an `Outcome`). Per-layer metrics
are read by `metrics/<metric>.py` (`read(rec) -> float or None`), found by
the names that `BENCHMARK.json` lists for the cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that must not be loaded in a run: JAX and the package the
# port was made from (compared whole, so `masg_tpu_torch` is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "masg_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, name: str) -> Tuple[dict, dict]:
    """(cell, configuration) of workload `name`: its file
    `workloads/<name>.json` names the configuration (`configs/<config>.json`)
    and the traffic mix (`mixes/<traffic>.json`, whose `driver` names the
    module that sends it) and holds the limits of its checks; its entry in
    `BENCHMARK.json`, where it has one, names the same two."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), {})
    if entry and (entry["config"], entry["traffic"]) != (cell["config"], cell["traffic"]):
        raise ValueError(f"{name}: BENCHMARK.json and workloads/{name}.json disagree")
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    cell = {"name": name, "chips": entry.get("chips", 1), **cell, "driver": mix["driver"],
            "traffic": mix}
    return cell, load_json(HERE / "configs" / f"{cell['config']}.json")


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The `end_to_end` or `per_layer` entries that cell `cell` reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """The forbidden top-level modules now in sys.modules."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


# --- host spans and counters --------------------------------------------------


@dataclass
class Record:
    """What a run saw. Spans are (name, start_ns, end_ns) on the host's
    realtime clock, the clock the profiler stamps device events with;
    `events` are the device kernels of the traced window (name, start_ns,
    duration_ns); `work` holds operation and byte counts from shapes."""

    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    events: List[Tuple[str, int, int]] = field(default_factory=list)
    trace_window: Optional[Tuple[int, int]] = None
    window_s: float = 0.0
    work: Dict[str, object] = field(default_factory=dict)
    dtype: str = "float32"

    def span(self, name: str):
        return _Span(self, name)

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


class _Span:
    def __init__(self, rec: Record, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec.spans.append((self.name, self.t0, time.time_ns()))
        return False


class NoSpan:
    """Stands in for a span when the run is not traced."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# --- the run's context ----------------------------------------------------------


@dataclass
class Check:
    """One number compared, with the limit it must not pass."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    breakdown_labels: Dict[str, str] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


@dataclass
class Context:
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float  # perf_counter at the start of the process's own code
    rec: Record = field(default_factory=Record)
    setup_s: Optional[float] = None
    memory_peak_bytes: int = 0

    def span(self, name: str):
        return self.rec.span(name) if self.trace else NoSpan()

    def stamp(self, name: str) -> None:
        """Records the seconds since the process started, at a point of set-up."""
        self.rec.counters[f"at_{name}_s"] = round(time.perf_counter() - self.started, 3)

    def window_opens(self) -> None:
        """Everything before this is set-up (and its spans are dropped)."""
        self.setup_s = time.perf_counter() - self.started
        self.rec.spans.clear()

    def window_closed(self) -> None:
        """Reads the memory peak; call before the reference runs."""
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str) -> Callable:
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seed_int(*parts: int) -> int:
    """A 63-bit seed derived from whole numbers."""
    import numpy as np

    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


# --- weights from the seed ------------------------------------------------------

EMBED_STD = {"embedding": 1.0, "embedding_small": 0.3}
BIAS_STD = 0.05


def make_weights(spec: List[Tuple[str, Tuple[int, ...], str]], gen, device: str,
                 fills: Dict[str, Callable]) -> Dict[str, "object"]:
    """Tensors for `spec` ((name, shape, kind)) on `device`: every random one
    is a slice of one normal draw of `gen`, scaled by its kind (1/sqrt(fan
    in) for weights), made in one call; `fills` gives the rest by kind."""
    import torch

    n = sum(math.prod(shape) for _, shape, kind in spec if kind not in fills)
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for name, shape, kind in spec:
        if kind in fills:
            out[name] = fills[kind](shape)
            continue
        k = math.prod(shape)
        t = flat[pos:pos + k].view(shape)
        pos += k
        if kind == "linear":
            t = t / math.sqrt(shape[1])
        elif kind == "conv":
            t = t / math.sqrt(shape[1] * shape[2])
        elif kind.startswith("conv_t/"):
            t = t / math.sqrt(shape[0] * shape[2] / int(kind.split("/")[1]))
        elif kind in EMBED_STD:
            t = t * EMBED_STD[kind]
        elif kind == "bias":
            t = t * BIAS_STD
        else:
            raise ValueError(f"no fill for {name} ({kind})")
        out[name] = t
    return out


# --- the device trace -------------------------------------------------------------


class Tracer:
    """A torch.profiler window over the device alone (CUDA activity): its
    kernels as (name, start_ns, duration_ns) on the realtime clock. The
    profiler starts (seconds, the first time) on entry, in set-up; the
    traced window runs from `mark()` to the exit."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def mark(self) -> None:
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        if self.enabled:
            import torch

            torch.cuda.synchronize()
            self.t1 = time.time_ns()
            self.prof.__exit__(*exc)
        return False

    def kernels(self) -> List[Tuple[str, int, int]]:
        import torch

        if self.prof is None:
            return []
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                out.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
        return out


def busy_and_gaps(rec: Record) -> Tuple[float, List[Tuple[int, int]]]:
    """(seconds some kernel ran inside the traced window: the length of the
    union of the kernels' intervals, the idle gaps between them as
    (start_ns, end_ns))."""
    lo, hi = rec.trace_window
    iv = sorted((max(s, lo), min(s + d, hi)) for _, s, d in rec.events if s + d > lo and s < hi)
    merged: List[List[int]] = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [x for m in merged for x in m] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return busy / 1e9, gaps


def breakdown(rec: Record) -> dict:
    """The device operations that took most time, by kernel name, and the
    longest idle gaps by the host span open at each gap's start."""
    by_name: Dict[str, int] = {}
    for name, _, d in rec.events:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    _, gaps = busy_and_gaps(rec)
    spans = sorted(rec.spans, key=lambda s: s[1])

    def label(t: int) -> str:
        inner = [s for s in spans if s[1] <= t < s[2]]
        return min(inner, key=lambda s: s[2] - s[1])[0] if inner else "between spans"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:120], d / 1e9] for n, d in ops],
            "idle_gaps": [[label(a), (b - a) / 1e9] for a, b in longest]}


# --- the result -------------------------------------------------------------------


def device_info(ctx: Context) -> dict:
    import torch

    if ctx.device.startswith("cuda"):
        platform, kind, count = "gpu", torch.cuda.get_device_name(0), int(ctx.cell.get("chips", 1))
    else:
        platform, kind, count = "cpu", "cpu", 1
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": ctx.memory_peak_bytes}


def result_line(ctx: Context, out: Outcome, bench: dict, name: str) -> dict:
    """The run's JSON result: end-to-end metrics without a trace, per-layer
    ones with it (each reader's None leaves its metric out)."""
    metrics = {}
    if not ctx.trace:
        for m in metrics_of(bench, name, "end_to_end"):
            # a metric named `<quantity>.<cells>` reports the driver's <quantity>
            quantity = m["name"].split(".")[0]
            value = ctx.setup_s if quantity == "setup_s" else out.e2e.get(quantity)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, name, "per_layer"):
            value = reader(m["name"])(ctx.rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info(ctx)}
    if ctx.trace and ctx.rec.trace_window:
        busy, _ = busy_and_gaps(ctx.rec)
        lo, hi = ctx.rec.trace_window
        line["device"].update(busy_s=busy, window_s=(hi - lo) / 1e9)
        line["breakdown"] = breakdown(ctx.rec)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def print_checks(out: Outcome) -> None:
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
