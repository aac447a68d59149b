"""The (data, model) mesh of data- and tensor-parallel training, and the
data axis of data-parallel serving (port of masg_tpu/parallel/mesh.py).

masg_tpu places one program over a (data, model) device mesh and lets XLA
shard the batch and the ruled weights and insert the collectives. Here each
of n_data x n_model processes holds its rows of the host's global batch
(every rank builds the same batches from the same seed) and its shard of
the weights `PARAM_RULES` split, and a `DataMesh` names this rank's place
and carries the collectives. Rank r sits at (data rank, model rank) =
divmod(r, n_model), the row-major order of masg_tpu's `make_mesh`. The
ranks of one model rank form a DATA GROUP, those of one data rank a MODEL
GROUP.

The data axis (`sum`, `gather_rows`, `reduce_grads`, `replicate`, over the
data group):

- a SHARDED batch (B % n_data == 0): this rank's B / n_data rows; losses are
  this rank's part of the global masked means (`sum`), BatchNorm takes its
  statistics over the global batch, and `reduce_grads` sums the parts'
  gradients into the one-device gradient;
- a REPLICATED batch (B % n_data != 0, masg_tpu's `replicate` fallback for a
  partial tail batch): the whole batch on every rank, every rank computing
  the one-device step; `sum` is the identity and `reduce_grads` averages,
  which keeps the replicas in step.

The model axis (`model_axis`, `parallel/tensor.py`): the ranks of a model
group hold the same rows and each computes the whole loss of them; the
layers split as `PARAM_RULES` says and all-reduce over the model group.

`DataMesh()` (1 x 1) is one device: every method is the identity and no
process group is needed.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from . import distributed as D
from .tensor import ModelAxis, gathered


def data_parallel_size(batch_size: int, n_devices: int) -> int:
    """Largest device count <= n_devices that divides batch_size evenly, so
    every full batch shards cleanly over the 'data' axis."""
    n = max(min(batch_size, n_devices), 1)
    while batch_size % n != 0:
        n -= 1
    return n


# masg_tpu's _PARAM_RULES (parallel/mesh.py:49-60) under the port's
# state-dict names: key -> the dimension split over the model axis. torch's
# Linear weights are (out, in) and Conv1d's (out, in, k), so flax's "out"
# is dim 0 and "in" dim 1. The row-parallel biases (w_2, fc) stay whole and
# are added once after the reduce; the PostNet convs' biases and the
# BatchNorms after them follow their channels (masg_tpu leaves those to
# GSPMD). A layer keeps a ruled weight whole when the axis does not divide
# its dimension, and attention splits by whole heads (`models/layers.py`).
# The layers report what they split (`sharded_params`); this copy of the
# rules documents the layout, and the tests hold the layers to it.
PARAM_RULES = [
    (re.compile(r".*pos_ffn\.w_1\.(weight|bias)$"), 0),
    (re.compile(r".*pos_ffn\.w_2\.weight$"), 1),
    (re.compile(r".*slf_attn\.w_[qkv]s\.(weight|bias)$"), 0),
    (re.compile(r".*slf_attn\.fc\.weight$"), 1),
    (re.compile(r"(.*\.)?postnet\.convolutions\.[0-3]\.0\.conv\.(weight|bias)$"), 0),
    (re.compile(r"(.*\.)?postnet\.convolutions\.[0-3]\.1\."
                r"(weight|bias|running_mean|running_var)$"), 0),
]


def rule_dim(name: str) -> Optional[int]:
    """The dimension `PARAM_RULES` splits the tensor `name` along, or None."""
    for rule, dim in PARAM_RULES:
        if rule.match(name):
            return dim
    return None


def sharded_names(module: torch.nn.Module) -> Dict[str, int]:
    """{state-dict key: split dimension} of the tensors of `module` that hold
    this rank's shard, as its split layers report them (`sharded_params`).
    Computed once and kept on `module`; do not mutate the result."""
    cached = module.__dict__.get("_sharded_names")
    if cached is None:
        cached = {}
        for prefix, sub in module.named_modules():
            if hasattr(sub, "sharded_params"):
                for key, dim in sub.sharded_params().items():
                    cached[f"{prefix}.{key}" if prefix else key] = dim
        module.__dict__["_sharded_names"] = cached
    return cached


def shard_state(full: Mapping[str, torch.Tensor], names: Mapping[str, int],
                axis: Optional[ModelAxis]) -> Dict[str, torch.Tensor]:
    """This rank's shard of a whole state dict: the `names` (`sharded_names`
    of the sharded module) cut to this rank's slice, the rest as they are."""
    if axis is None:
        return dict(full)
    return {k: axis.shard(v, names[k]) if k in names else v for k, v in full.items()}


def unshard_state(local: Mapping[str, torch.Tensor], names: Mapping[str, int],
                  axis: Optional[ModelAxis]) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's shard: collective over the
    model group (every rank of it calls this, with the same keys)."""
    if axis is None:
        return dict(local)
    return {k: unshard_tensor(v, names[k], axis) if k in names else v
            for k, v in local.items()}


@torch.no_grad()
def unshard_tensor(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """The whole tensor from the ranks' slices along `dim` (collective)."""
    return gathered(t.detach(), dim, axis.size, axis.rank, axis.group)


@dataclass(frozen=True)
class DataMesh:
    n_data: int = 1
    rank: int = 0  # this process's data rank
    sharded: bool = True  # False: this batch runs whole on every rank
    n_model: int = 1
    model_rank: int = 0
    data_group: Any = None  # None: the default group (n_model 1)
    model_group: Any = None

    @classmethod
    def from_process_group(cls, batch_size: Optional[int] = None,
                           n_model: int = 1) -> "DataMesh":
        """The (world / n_model, n_model) mesh of the joined process group
        (1 x 1 without one). With `batch_size`, every data rank must hold a
        share of it: raises unless the data axis divides it. Creates the
        mesh's groups: every process calls it, with the same arguments."""
        world = D.world_size()
        if n_model < 1 or world % n_model:
            raise ValueError(f"--n_model {n_model} does not divide the {world} processes")
        n_data = world // n_model
        if batch_size is not None and data_parallel_size(batch_size, n_data) != n_data:
            raise ValueError(f"batch size {batch_size} does not split over {n_data} data "
                             f"ranks; start data_parallel_size(batch_size, n) = "
                             f"{data_parallel_size(batch_size, n_data)} of them")
        d, m = divmod(D.rank(), n_model)
        if n_model == 1:
            return cls(n_data=n_data, rank=d)
        # every process creates every group, in one order
        new_group = torch.distributed.new_group
        data_groups = ([new_group(list(range(j, world, n_model))) for j in range(n_model)]
                       if n_data > 1 else [None] * n_model)
        model_groups = [new_group(list(range(i * n_model, (i + 1) * n_model)))
                        for i in range(n_data)]
        return cls(n_data=n_data, rank=d, n_model=n_model, model_rank=m,
                   data_group=data_groups[m], model_group=model_groups[d])

    @property
    def is_lead(self) -> bool:
        """Rank 0 of the world: the process that logs and writes files."""
        return self.rank == 0 and self.model_rank == 0

    @property
    def lead_row(self) -> bool:
        """Whether this rank is at data rank 0: the model group that runs the
        lead's evaluation, samples and checkpoint gathers together."""
        return self.rank == 0

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """This rank's model axis for the layers (None at n_model 1)."""
        if self.n_model == 1:
            return None
        return ModelAxis(self.n_model, self.model_rank, self.model_group)

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

    # -- collectives over the data group ---------------------------------
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the data ranks' parts (autograd-aware); the identity
        unless this batch is sharded."""
        return D.all_reduce_sum(x, self.data_group) if self.parts > 1 else x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' rows in order (autograd-aware); the identity
        unless this batch is sharded."""
        return D.all_gather_rows(x, self.data_group) if self.parts > 1 else x

    def reduce_grads(self, params: Iterable[torch.nn.Parameter], average: bool = False) -> None:
        """Sum (sharded; `average`: the mean) the data ranks' gradients of
        the `params` that have one, in place, in one all-reduce per dtype.
        Replicated: the mean, which every rank already holds."""
        if self.n_data == 1:
            return
        grads = [p.grad for p in params if p.grad is not None]
        D.all_reduce_(grads, self.data_group)
        if average or not self.sharded:
            for g in grads:
                g.div_(self.n_data)

    def replicate(self, tensors: Iterable[torch.Tensor]) -> None:
        """Data rank 0's values of `tensors` on every data rank (parameters
        and buffers at start and after a restore; a shard stays within its
        model rank's data group)."""
        if self.n_data > 1:
            src = (0 if self.data_group is None
                   else torch.distributed.get_global_rank(self.data_group, 0))
            D.broadcast_(list(tensors), src, self.data_group)

    # -- over the world ----------------------------------------------------
    def barrier(self) -> None:
        if self.n_data * self.n_model > 1:
            D.barrier()

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (a preemption signal that only
        some processes received)."""
        if self.n_data * self.n_model == 1:
            return flag
        t = torch.tensor([float(flag)])
        if torch.distributed.get_backend() == "nccl":
            t = t.cuda()
        torch.distributed.all_reduce(t)
        return bool(t.item() > 0)


def add_parallel_flags(parser) -> None:
    """masg_tpu's mesh flags: `--n_devices`, `--n_model`, `--multihost`."""
    parser.add_argument("--n_devices", type=int, default=None,
                        help="train over the first N devices (default: --n_model of "
                             "them): one process per card, spawned here (with --device "
                             "cpu, N CPU processes over gloo)")
    parser.add_argument("--n_model", type=int, default=1,
                        help="tensor-parallel axis size of the (data, model) mesh (the "
                             "FastSpeech2 trainers; the others take only 1)")
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


def launch_data_parallel(run: Callable[[Any, str], Any], args, batch_size: int,
                         model_axis: bool = True) -> Any:
    """Run `run(args, device)` over the (data, model) mesh the CLI's flags ask
    for, with M = `--n_model`:

    - `--multihost`: join the group the environment names, on card
      LOCAL_RANK (or the CPU under `--device cpu`), and run here; the world
      size is n_data x M;
    - otherwise N = `--n_devices` (default M), capped at the cards present
      (under `--device cpu`, N processes); the data axis is
      `data_parallel_size(batch_size, max(N // M, 1))` as masg_tpu sizes it,
      and n_data x M workers are spawned over a local rendezvous (NCCL on
      the cards, gloo on the CPU); returns None. Raises when the mesh needs
      more devices than N; one process runs here.

    `model_axis` False (the GE2E and vocoder trainers, which masg_tpu runs
    with n_model=1): `--n_model` > 1 raises. `run` must be a module-level
    function (a spawned worker imports it)."""
    from ..device import resolve_device

    m = args.n_model
    if m < 1 or (m > 1 and not model_axis):
        raise ValueError(f"--n_model {m}: masg_tpu trains this model with no model axis "
                         f"(n_model=1); --n_devices and --multihost train it data-parallel")
    cuda = resolve_device(args.device).type == "cuda"
    if args.multihost:
        env = os.environ
        local = int(env.get("LOCAL_RANK", env.get("MASG_PROCESS_ID", env.get("RANK", 0))))
        device = f"cuda:{local % torch.cuda.device_count()}" if cuda else args.device
        D.initialize(device=torch.device(device))
        D.barrier()  # every process has joined, over the backend's own communicator
        if D.world_size() % m:
            raise ValueError(f"--n_model {m} does not divide the {D.world_size()} processes")
        print(f"mesh: {{'data': {D.world_size() // m}, 'model': {m}}} (process {D.rank()}, "
              f"backend {torch.distributed.get_backend()})", flush=True)
        try:
            return run(args, device)
        finally:
            D.shutdown()
    n = args.n_devices or m
    if cuda:
        n = min(n, torch.cuda.device_count())
    n_data = data_parallel_size(batch_size, max(n // m, 1))
    world = n_data * m
    if world > n:
        where = f"{n} card(s) visible" if cuda else f"--n_devices {n}"
        raise ValueError(f"--n_model {m} needs {m} devices, {where}; give --n_devices "
                         f"(with --device cpu, that many CPU processes)")
    print(f"mesh: {{'data': {n_data}, 'model': {m}}}", flush=True)
    if world == 1:
        return run(args, args.device)
    D.spawn(_dp_worker, world, args=(run, args), backend="nccl" if cuda else "gloo")
    return None
