"""Tracing and step timing (port of masg_tpu/utils/profiling.py).

masg_tpu wraps `jax.profiler` and a host fetch that stands in for a device
barrier on its remoted TPU. Here: a `torch.profiler` window that writes a
Chrome trace (CPU activity, and the card's kernels when it is on a card),
`true_sync`, which waits for the device work queued on a tensor's device,
and `StepTimer`, a rolling steps/s that synchronises every `sync_every`
steps only (every step would serialise the host against the device).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write `<log_dir>/trace.json` (Chrome trace
    format, for chrome://tracing or Perfetto). Records the card's activity
    too when a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        true_sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def true_sync(x: Optional[torch.Tensor] = None) -> None:
    """Wait for the device work queued so far: on `x`'s card (every card
    when `x` is None); a no-op for CPU tensors, whose work is done on return."""
    if x is not None and x.device.type != "cuda":
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize(None if x is None else x.device)


class StepTimer:
    """Rolling steps/sec with device syncs every `sync_every` steps
    (syncing every step would serialize the dispatch pipeline)."""

    def __init__(self, sync_every: int = 50):
        self.sync_every = sync_every
        self.count = 0
        self.t0: Optional[float] = None
        self.rate = 0.0

    def step(self, device_output: Optional[torch.Tensor] = None) -> float:
        if self.t0 is None:
            true_sync(device_output)
            self.t0 = time.perf_counter()
            self.count = 0
            return self.rate
        self.count += 1
        if self.count % self.sync_every == 0:
            true_sync(device_output)
            dt = time.perf_counter() - self.t0
            self.rate = self.count / dt
        return self.rate
