"""Tensor- and data-parallel regions: the collectives XLA inserts in the JAX package.

Under `jax.jit` with named shardings XLA places the all-reduces and all-gathers
itself. Here they are written out, as Megatron-LM's four region functions over the
mesh's 'model' group, each an `autograd.Function` whose backward is its forward's
adjoint:

  copy      identity forward, all-reduce backward (entering a sharded product
            from a replicated activation);
  reduce    all-reduce forward, identity backward (leaving a row-parallel product);
  gather    all-gather forward, own slice backward (leaving a column-parallel
            product into replicated code);
  scatter   own slice forward, all-gather backward.

`torch.distributed.nn.functional.all_reduce`/`all_gather` are not used for these:
their backward sums over ranks, and downstream of a region the activations are
replicated, so that would give `n_model` times the gradient on every leaf before
the region.

A parameter sharded over 'model' carries `_tp_dim`, the dimension it is split on
(`parallel/mesh.py::shard_params` sets it); `split_dim` reads it, and the layers
(`models/layers.py`) take the tensor-parallel form only for such a parameter, so a
model with no sharded parameter runs exactly as before. The 'model' group is one
per process (one process drives one device), set with `set_model_group`.

`global_sum` is the data side: inside `data_parallel(group)` it all-reduces a
partial sum over the batch shards (identity backward), so that a loss divides by
the global denominator and every rank holds the global loss; the gradients are
then summed over 'data' by the optimizer state. Outside that context it is the
identity, and the losses are those of one device.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_MODEL = {"group": None, "size": 1, "rank": 0}
_DATA = {"group": None, "size": 1}


def set_model_group(group, size: int, rank: int) -> None:
    """The 'model' group of this process's mesh (None and 1: no tensor parallelism)."""
    _MODEL.update(group=group, size=size, rank=rank)


def model_size() -> int:
    return _MODEL["size"]


def model_rank() -> int:
    return _MODEL["rank"]


def split_dim(t: torch.Tensor) -> Optional[int]:
    """The dimension a parameter is sharded on over 'model', or None (replicated)."""
    return getattr(t, "_tp_dim", None)


def mark(p: torch.Tensor, dim: int) -> torch.Tensor:
    p._tp_dim = dim
    return p


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_cat(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Concatenate every 'model' rank's `x` along `dim`, in rank order (no autograd)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_MODEL["size"])]
    dist.all_gather(parts, x, group=_MODEL["group"])
    return torch.cat(parts, dim=dim)


def own_slice(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This 'model' rank's contiguous block of `x` along `dim`."""
    return x.chunk(_MODEL["size"], dim=dim)[_MODEL["rank"]].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, _MODEL["group"])


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_gather_cat(x, -1)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, -1)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return own_slice(x, -1)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, -1)


def copy(x: torch.Tensor) -> torch.Tensor:
    return _Copy.apply(x) if _MODEL["size"] > 1 else x


def reduce(x: torch.Tensor) -> torch.Tensor:
    return _Reduce.apply(x, _MODEL["group"]) if _MODEL["size"] > 1 else x


def gather(x: torch.Tensor) -> torch.Tensor:
    """Last (channel) dimension gathered over 'model'."""
    return _Gather.apply(x) if _MODEL["size"] > 1 else x


def scatter(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the last (channel) dimension."""
    return _Scatter.apply(x) if _MODEL["size"] > 1 else x


# ---------------------------------------------------------------- data parallel


@contextlib.contextmanager
def data_parallel(group, size: int):
    """Losses computed inside see the global batch through `global_sum`."""
    prev = dict(_DATA)
    _DATA.update(group=group, size=size)
    try:
        yield
    finally:
        _DATA.update(prev)


def data_size() -> int:
    return _DATA["size"]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` (a partial sum over this rank's batch rows) summed over 'data'."""
    return _Reduce.apply(x, _DATA["group"]) if _DATA["size"] > 1 else x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the global batch (every shard has x's shape)."""
    return global_sum(x.sum()) / (x.numel() * _DATA["size"])
