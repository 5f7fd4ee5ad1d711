"""Parallelism: device mesh, sharding rules, tensor-parallel regions."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    gather_params,
    init_distributed,
    init_group,
    local_rows,
    make_hybrid_mesh,
    make_mesh,
    param_shardings,
    param_spec,
    rank_device,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "gather_params",
    "init_distributed",
    "init_group",
    "local_rows",
    "make_hybrid_mesh",
    "make_mesh",
    "param_shardings",
    "param_spec",
    "rank_device",
    "shard_params",
]
