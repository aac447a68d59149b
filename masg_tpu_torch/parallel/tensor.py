"""The model axis of tensor-parallel training (port of the 'model' axis of
masg_tpu/parallel/mesh.py, Megatron-style).

masg_tpu annotates weights with a PartitionSpec over its mesh's 'model' axis
and lets GSPMD insert the collectives. Here each of `size` processes of a
model group holds its shard of the split weights, and the layers call three
operators at the boundaries of the split (`models/layers.py`,
`models/postnet.py`):

- `copy_to_model` (Megatron's f) at the input of a column-parallel layer:
  the identity forward; backward, the sum of the ranks' cotangents, since
  each rank's columns see only their part of the input's gradient;
- `reduce_from_model` (g) after a row-parallel layer: the sum of the ranks'
  partial products forward; the identity backward;
- `gather_from_model`: the ranks' channel shards concatenated forward;
  backward, THIS RANK'S SLICE of the cotangent, with no sum.

Every rank of a model group computes the same, whole loss of its rows, so
the cotangent that reaches a replicated activation is the same on every
rank. That is why the gather's backward must not sum: `all_gather_rows`'
backward sums, which is right for data parallelism (each rank holds a part
of the loss) and returns M times the gradient here. All three are built on
`all_reduce`, like the data-parallel collectives (`parallel/distributed.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .distributed import reduced


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduced(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gathered(x: torch.Tensor, dim: int, size: int, rank: int, group=None) -> torch.Tensor:
    """The `size` ranks' equal shards of a tensor along `dim`, concatenated in
    rank order, from an all-reduce of a zero-padded buffer (no autograd)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    buf = x.new_zeros(shape)
    buf.narrow(dim, rank * n, n).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, size, rank, group):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return gathered(x, dim, size, rank, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None, None


def copy_to_model(x: torch.Tensor, group=None) -> torch.Tensor:
    """f: the identity; its backward sums the cotangents over `group`."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group=None) -> torch.Tensor:
    """g: the sum of `x` over `group`; the identity backward."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, size: int, rank: int,
                      group=None) -> torch.Tensor:
    """The ranks' shards of `x` along `dim`, concatenated; backward, this
    rank's slice of the cotangent (no sum)."""
    return _GatherFromModel.apply(x, dim, size, rank, group)


@dataclass(frozen=True, eq=False)
class ModelAxis:
    """This process's place on a model axis of `size` ranks, and the group
    of those ranks (None: the default group). The layers hold it; a copy of
    a layer shares it."""

    size: int
    rank: int
    group: Any = None

    def splits(self, n: int) -> bool:
        """Whether a dimension of n splits over the axis (else the weight
        stays whole on every rank, as masg_tpu's `shard_params` keeps it)."""
        return n % self.size == 0

    def shard(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's equal slice of a whole tensor along `dim`."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n).clone()

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return gather_from_model(x, dim, self.size, self.rank, self.group)

    def __deepcopy__(self, memo):
        return self  # a process group is not copied
