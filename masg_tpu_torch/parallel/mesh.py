"""The data axis of data-parallel training and serving (port of the data
half of masg_tpu/parallel/mesh.py).

masg_tpu places one program over a (data, model) device mesh and lets XLA
shard the batch and insert the gradient all-reduce. Here each of `n_data`
processes holds a full replica and its rows of the host's global batch
(every rank builds the same batches from the same seed), and a `DataMesh`
names this rank's share and carries the collectives the train steps call:

- a SHARDED batch (B % n_data == 0): this rank's B / n_data rows; losses are
  this rank's part of the global masked means (`sum`), BatchNorm takes its
  statistics over the global batch, and `reduce_grads` sums the parts'
  gradients into the one-device gradient;
- a REPLICATED batch (B % n_data != 0, masg_tpu's `replicate` fallback for a
  partial tail batch): the whole batch on every rank, every rank computing
  the one-device step; `sum` is the identity and `reduce_grads` averages,
  which keeps the replicas in step.

`DataMesh()` (n_data 1) is one device: every method is the identity and no
process group is needed. The tensor-parallel axis (masg_tpu's
`_PARAM_RULES`) is not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from . import distributed as D


def data_parallel_size(batch_size: int, n_devices: int) -> int:
    """Largest device count <= n_devices that divides batch_size evenly, so
    every full batch shards cleanly over the 'data' axis."""
    n = max(min(batch_size, n_devices), 1)
    while batch_size % n != 0:
        n -= 1
    return n


def check_model_axis(n_model: int) -> None:
    """Tensor parallelism (`--n_model > 1`) is not ported: raise for it."""
    if n_model > 1:
        from ..train.step import unported

        raise unported("--n_model > 1 (tensor parallel)", 12)


@dataclass(frozen=True)
class DataMesh:
    n_data: int = 1
    rank: int = 0
    sharded: bool = True  # False: this batch runs whole on every rank

    @classmethod
    def from_process_group(cls, batch_size: Optional[int] = None) -> "DataMesh":
        """The mesh of the joined process group (n_data 1 without one). With
        `batch_size`, every rank must hold a share of it: raises unless the
        world size divides it."""
        n = D.world_size()
        if batch_size is not None and data_parallel_size(batch_size, n) != n:
            raise ValueError(f"batch size {batch_size} does not split over {n} processes; "
                             f"start data_parallel_size(batch_size, n) = "
                             f"{data_parallel_size(batch_size, n)} of them")
        return cls(n_data=n, rank=D.rank())

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    @property
    def parts(self) -> int:
        """How many ranks share this batch's rows (1 when it is replicated)."""
        return self.n_data if self.sharded else 1

    def for_batch(self, batch_size: int) -> "DataMesh":
        """This mesh for a batch of `batch_size` rows: sharded when n_data
        divides it, else replicated."""
        return replace(self, sharded=self.n_data > 1 and batch_size % self.n_data == 0)

    def rows(self, batch_size: int) -> slice:
        if self.parts == 1:
            return slice(0, batch_size)
        per = batch_size // self.n_data
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's rows of a host batch (all of them when replicated;
        use the mesh `for_batch` returns). A global `reorder` (the speaker
        shuffle of `--use_clf`/ganlike) becomes the rows' shuffled
        `reorder_speakers`/`reorder_speaker_meta`, and `lang_jitter` (one
        value per 150-frame chunk of each row) is cut by rows too."""
        b = len(batch["speakers"])
        rows = self.rows(b)
        batch = dict(batch)
        reorder = batch.pop("reorder", None)
        if reorder is not None:
            reorder = np.asarray(reorder)
            batch["reorder_speakers"] = np.asarray(batch["speakers"])[reorder]
            batch["reorder_speaker_meta"] = np.asarray(batch["speaker_meta"])[reorder]
        out = {}
        for k, v in batch.items():
            if k == "lang_jitter":
                v = np.asarray(v)
                out[k] = v.reshape(b, -1)[rows].reshape(-1)
            elif isinstance(v, (list, tuple)):
                out[k] = v[rows]
            else:
                out[k] = np.asarray(v)[rows]
        return out

    # -- collectives ----------------------------------------------------
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' parts (autograd-aware); the identity unless
        this batch is sharded."""
        return D.all_reduce_sum(x) if self.parts > 1 else x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' rows in order (autograd-aware); the identity unless
        this batch is sharded."""
        return D.all_gather_rows(x) if self.parts > 1 else x

    def reduce_grads(self, params: Iterable[torch.nn.Parameter], average: bool = False) -> None:
        """Sum (sharded; `average`: the mean) the ranks' gradients of the
        `params` that have one, in place, in one all-reduce per dtype.
        Replicated: the mean, which every rank already holds."""
        if self.n_data == 1:
            return
        grads = [p.grad for p in params if p.grad is not None]
        D.all_reduce_(grads)
        if average or not self.sharded:
            for g in grads:
                g.div_(self.n_data)

    def replicate(self, tensors: Iterable[torch.Tensor]) -> None:
        """Rank 0's values of `tensors` on every rank (parameters and
        buffers at start and after a restore)."""
        if self.n_data > 1:
            D.broadcast_(list(tensors))

    def barrier(self) -> None:
        if self.n_data > 1:
            D.barrier()

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (a preemption signal that only
        some processes received)."""
        if self.n_data == 1:
            return flag
        t = torch.tensor([float(flag)])
        if torch.distributed.get_backend() == "nccl":
            t = t.cuda()
        torch.distributed.all_reduce(t)
        return bool(t.item() > 0)


def add_parallel_flags(parser) -> None:
    """masg_tpu's mesh flags: `--n_devices`, `--n_model`, `--multihost`."""
    parser.add_argument("--n_devices", type=int, default=None,
                        help="data-parallel over the first N devices (default 1): one "
                             "process per card, spawned here (with --device cpu, N CPU "
                             "processes over gloo)")
    parser.add_argument("--n_model", type=int, default=1,
                        help="tensor-parallel axis (only 1 is ported)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group from the environment instead "
                             "(MASG_COORDINATOR / MASG_NUM_PROCESSES / MASG_PROCESS_ID, "
                             "or torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / "
                             "RANK / LOCAL_RANK); one process per card")


def _dp_worker(rank: int, world: int, run: Callable, args) -> None:
    if torch.device(args.device).type == "cuda":
        run(args, f"cuda:{rank}")
    else:  # CPU ranks share the host's cores, as torchrun's OMP_NUM_THREADS does
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        run(args, args.device)


def launch_data_parallel(run: Callable[[Any, str], Any], args, batch_size: int) -> Any:
    """Run `run(args, device)` data-parallel as a CLI's flags ask:

    - `--multihost`: join the group the environment names, on card
      LOCAL_RANK (or the CPU under `--device cpu`), and run here;
    - `--n_devices N` > 1: cap N at the cards present (under `--device cpu`,
      N processes), size the data axis `data_parallel_size(batch_size, N)`
      as masg_tpu does, and spawn that many workers over a local rendezvous
      (NCCL on the cards, gloo on the CPU); returns None;
    - otherwise run here on `args.device`.

    `run` must be a module-level function (a spawned worker imports it)."""
    from ..device import resolve_device

    check_model_axis(args.n_model)
    cuda = resolve_device(args.device).type == "cuda"
    if args.multihost:
        env = os.environ
        local = int(env.get("LOCAL_RANK", env.get("MASG_PROCESS_ID", env.get("RANK", 0))))
        device = f"cuda:{local % torch.cuda.device_count()}" if cuda else args.device
        D.initialize(device=torch.device(device))
        D.barrier()  # every process has joined, over the backend's own communicator
        print(f"mesh: {{'data': {D.world_size()}, 'model': 1}} (process {D.rank()}, "
              f"backend {torch.distributed.get_backend()})", flush=True)
        try:
            return run(args, device)
        finally:
            D.shutdown()
    n = args.n_devices or 1
    if cuda:
        n = min(n, torch.cuda.device_count())
    n_data = data_parallel_size(batch_size, n)
    print(f"mesh: {{'data': {n_data}, 'model': 1}}", flush=True)
    if n_data == 1:
        return run(args, args.device)
    D.spawn(_dp_worker, n_data, args=(run, args), backend="nccl" if cuda else "gloo")
    return None
