"""Process groups and the collectives of data-parallel training
(port of masg_tpu/parallel/distributed.py).

masg_tpu joins hosts with `jax.distributed.initialize` and lets XLA insert
the collectives of a sharded step. Here one process drives one device, the
processes join a `torch.distributed` group, and the steps call the few
collectives they need, all built on `all_reduce` and `broadcast`: gloo has
no `all_gather` for CUDA tensors and NCCL refuses two ranks on one device,
so one code path serves NCCL across cards, gloo on the CPU, and gloo with
CUDA tensors for ranks that share a card.

Autograd convention: under data parallelism every rank's objective is its
PART of the one-device objective (its rows' share of a global mean), and
the train step SUMS the ranks' gradients. A tensor that an all-reduce makes
the same on every rank is then read by each rank's part, so its cotangent is
the sum of the ranks' cotangents: the backward of `all_reduce_sum` is an
all-reduce too, and so is that of `all_gather_rows` before it takes this
rank's rows. A rank that computes a whole replicated loss from gathered rows
counts 1 / world_size of it as its part (`train/ge2e.py`).

`initialize` reads masg_tpu's environment names (MASG_COORDINATOR,
MASG_NUM_PROCESSES, MASG_PROCESS_ID, MASG_INIT_TIMEOUT) and torchrun's
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK). `spawn` starts
one worker per rank on this host with a local rendezvous, as
`cli.train --n_devices N` does.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device: Optional[torch.device] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the process group. Arguments override the environment: first
    masg_tpu's names, then torchrun's. `backend` defaults to nccl for a CUDA
    `device` (default: a card when one is present) and gloo otherwise; gloo
    also carries CUDA tensors, for ranks that share a card. Raises when
    neither the arguments nor the environment name a coordinator, or the
    rendezvous does not complete within `timeout_s` (MASG_INIT_TIMEOUT,
    default 600 s), which also bounds every later collective."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("MASG_COORDINATOR") or (
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
            if "MASTER_ADDR" in env else None)
    if num_processes is None:
        num_processes = int(env.get("MASG_NUM_PROCESSES", env.get("WORLD_SIZE", 0))) or None
    if process_id is None and ("MASG_PROCESS_ID" in env or "RANK" in env):
        process_id = int(env.get("MASG_PROCESS_ID", env.get("RANK")))
    if coordinator_address is None or num_processes is None or process_id is None:
        raise RuntimeError(
            "no process group to join: set MASG_COORDINATOR (host:port), "
            "MASG_NUM_PROCESSES and MASG_PROCESS_ID, or torchrun's MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK")
    if timeout_s is None:
        timeout_s = float(env.get("MASG_INIT_TIMEOUT", DEFAULT_TIMEOUT_S))
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":  # NCCL works on the current card
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n: int, r: int):
        rows = x.shape[0]
        ctx.rows, ctx.r = rows, r
        buf = x.new_zeros((n * rows,) + tuple(x.shape[1:]))
        buf[r * rows:(r + 1) * rows] = x
        dist.all_reduce(buf)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g[ctx.r * ctx.rows:(ctx.r + 1) * ctx.rows], None, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, on every rank (autograd: see the module
    docstring)."""
    return _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' `x` (equal shapes) stacked along dim 0 in rank order, on
    every rank, from an all-reduce of a zero-padded buffer (autograd: the
    backward sums the ranks' cotangents and returns this rank's rows)."""
    return _AllGatherRows.apply(x, world_size(), rank())


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite `tensors` on every rank with rank `src`'s, in place."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src)


def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum `tensors` over the ranks in place, coalesced: one flat all-reduce
    per dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _worker(r: int, fn: Callable, n: int, port: int, backend: str,
            timeout_s: Optional[float], results, args) -> None:
    device = torch.device("cuda", r) if backend == "nccl" else torch.device("cpu")
    initialize(f"localhost:{port}", n, r, backend=backend, device=device,
               timeout_s=timeout_s)
    try:
        out = fn(r, n, *args)
        results.put((r, out))
    finally:
        shutdown()


def spawn(fn: Callable[..., Any], nprocs: int, args: Sequence[Any] = (),
          backend: str = "gloo", timeout_s: Optional[float] = None) -> List[Any]:
    """Run `fn(rank, world_size, *args)` in `nprocs` fresh processes that form
    a process group over a rendezvous on a free localhost port, and return
    their results in rank order. `fn` must be importable (pickled by name);
    its results travel through a queue, so they hold host data only. With
    backend "nccl" rank r works on `cuda:r`; with gloo `fn` places its
    tensors where it likes (the CPU, or CUDA tensors of ranks sharing a
    card). A worker that raises fails the call, and one that
    has not finished after `timeout_s` (None: no limit) is terminated and
    fails it too."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    procs = mp.start_processes(_worker, args=(fn, nprocs, port, backend, timeout_s, results,
                                              tuple(args)),
                               nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out = {}
    try:
        while len(out) < nprocs:
            while not results.empty():  # drain before the join
                r, v = results.get()
                out[r] = v
            done = procs.join(timeout=1.0)
            if done:
                while not results.empty():
                    r, v = results.get()
                    out[r] = v
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawn: {nprocs} workers did not finish in {timeout_s} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join(timeout=10)
    missing = [r for r in range(nprocs) if r not in out]
    if missing:
        raise RuntimeError(f"spawn: ranks {missing} returned no result")
    return [out[r] for r in range(nprocs)]
