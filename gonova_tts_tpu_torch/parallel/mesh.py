"""Device mesh and sharding rules.

Counterpart of `gonova_tts_tpu/parallel/mesh.py`, with its names and rules. The
JAX package runs one process per host over a `jax.sharding.Mesh`; PyTorch runs one
process per device, so the mesh is a `torch.distributed.device_mesh.DeviceMesh`
over the ranks of the process group, ('data', 'model'), built with
`init_device_mesh`: rank = data_index * n_model + model_index. NCCL on CUDA, gloo
on the CPU.

Training shards the batch over 'data' and the wide hidden/channel dimensions over
'model' (tensor parallelism, `parallel/tp.py`); serving uses data-parallel
replicas (`engine/multi.py`). The pattern rules, keyed on parameter paths, are the
JAX package's, first match winning; a dimension the mesh axis does not divide
falls back to replicated, and says so.
"""

from __future__ import annotations

import copy
import os
import re
from datetime import timedelta
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from ..utils import get_logger
from . import tp

logger = get_logger("gonova.parallel")

DATA_AXIS = "data"
MODEL_AXIS = "model"

# How many workers each host process started (init_distributed's local_size): ranks
# process_index * local_size .. + local_size - 1 share one host.
_HOST = {"local_size": 1}


class Member(NamedTuple):
    """One mesh position: a rank of the process group and the host process that
    started it (the port's counterpart of a JAX device's `process_index`)."""

    rank: int
    process_index: int


def mesh_devices() -> List[Member]:
    """Every rank of the initialized process group (none before init)."""
    if not dist.is_initialized():
        return []
    return [Member(r, r // _HOST["local_size"]) for r in range(dist.get_world_size())]


def n_hosts() -> int:
    """Host processes of the process group (1 before init)."""
    return dist.get_world_size() // _HOST["local_size"] if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def rank_device() -> torch.device:
    """This rank's device: its CUDA card under NCCL, else the CPU."""
    if dist.is_initialized() and _device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _device_mesh(n_data: int, n_model: int):
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 0
    if n_data * n_model != world:
        raise ValueError(
            f"mesh {n_data}x{n_model} must cover the process group's {world} ranks "
            "(one process drives one device)"
        )
    return init_device_mesh(_device_type(), (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(n_data: Optional[int], n_model: int, n: int) -> Tuple[int, int]:
    """(n_data, n_model) of a mesh over `n` devices: `n_data` None takes them all."""
    if n_data is None:
        if n % n_model != 0:
            raise ValueError(f"{n} devices not divisible by model axis {n_model}")
        n_data = n // n_model
    if n_data * n_model > n:
        raise ValueError(f"mesh {n_data}x{n_model} exceeds {n} devices")
    return n_data, n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices: Optional[Sequence] = None):
    """A 2-D ('data', 'model') mesh. Defaults to every rank on the data axis."""
    devices = list(devices if devices is not None else mesh_devices())
    return _device_mesh(*mesh_shape(n_data, n_model, len(devices)))


def init_group(init_method: str, world: int, rank: int, local_rank: int = 0, local_size: int = 1, device=None) -> None:
    """Join the process group: NCCL with this worker's card (`local_rank`) current
    on CUDA, gloo on the CPU. A backend that cannot start raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank, timeout=timedelta(minutes=10)
    )
    _HOST["local_size"] = local_size


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_rank: int = 0,
    local_size: int = 1,
    device=None,
) -> bool:
    """Multi-host bring-up from explicit arguments or the environment, with the JAX
    package's contract (all optional; absent ⇒ single-host no-op):

      TTS_COORDINATOR      host:port of process 0 (the TCP store's address)
      TTS_NUM_PROCESSES    total host processes
      TTS_PROCESS_ID       this host's rank

    JAX runs one process per host driving every local device; here a host process
    starts one worker per local device (`train.loop.train` does), and each worker
    calls this with its `local_rank` of `local_size`: global rank =
    process_id * local_size + local_rank. Returns True iff the process group is
    initialized (idempotent)."""
    coordinator_address = coordinator_address or os.environ.get("TTS_COORDINATOR")
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(os.environ.get("TTS_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("TTS_PROCESS_ID", "0"))
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    init_group(
        init_method, num_processes * local_size, process_id * local_size + local_rank,
        local_rank, local_size, device,
    )
    return True


def make_hybrid_mesh(n_model: int = 1, devices: Optional[Sequence] = None):
    """Multi-host mesh: ('data', 'model') where 'model' never crosses a host
    boundary. Tensor-parallel collectives are latency-bound and stay on one host's
    links; 'data' spans hosts (outer) and fills the rest of each host (inner). A
    host's ranks are contiguous, so the rank-major grid keeps that invariant.
    Single-host degrades to `make_mesh` exactly."""
    devices = list(devices if devices is not None else mesh_devices())
    procs = sorted({d.process_index for d in devices})
    n_hosts = len(procs)
    if n_hosts == 1:
        return make_mesh(n_model=n_model, devices=devices)
    per_host = len(devices) // n_hosts
    if per_host * n_hosts != len(devices):
        raise ValueError(f"{len(devices)} devices uneven across {n_hosts} hosts")
    if per_host % n_model != 0:
        raise ValueError(
            f"model axis {n_model} does not divide the {per_host} per-host devices —"
            " 'model' must stay inside one host"
        )
    return _device_mesh(len(devices) // n_model, n_model)


# Parameter sharding rules: (path regex, axis tuple). First match wins. Paths are
# '/'-joined names, e.g. "acoustic/encoder/blocks/0/ff1/w" (a parameter's name with
# '/' for '.'); an axis tuple is a JAX PartitionSpec's entries.
_PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # Embedding table: shard the model dim.
    (r".*embed/table$", (None, MODEL_AXIS)),
    # Attention projections: q/k/v shard heads (out dim); o shards the in dim.
    (r".*attn/(q|k|v)/w$", (None, MODEL_AXIS)),
    (r".*attn/o/w$", (MODEL_AXIS, None)),
    (r".*attn/(q|k|v)/b$", (MODEL_AXIS,)),
    # Conv FFN: expand shards out-channels, contract shards in-channels.
    (r".*ff1/w$", (None, None, MODEL_AXIS)),
    (r".*ff1/b$", (MODEL_AXIS,)),
    (r".*ff2/w$", (None, MODEL_AXIS, None)),
    # Vocoder convs: shard out-channels on wide layers (in-channels stay replicated:
    # upsample stages halve channels, keeping the contraction local).
    (r"vocoder/conv_pre/w$", (None, None, MODEL_AXIS)),
    (r"vocoder/conv_pre/b$", (MODEL_AXIS,)),
    # NovaVocos (iSTFT vocoder): pointwise MLPs shard like FFNs; the head and iDFT
    # stay replicated (bins dim is odd, 513).
    (r"vocoder/embed/w$", (None, None, MODEL_AXIS)),
    (r"vocoder/embed/b$", (MODEL_AXIS,)),
    (r"vocoder/blocks/\d+/pw1/w$", (None, MODEL_AXIS)),
    (r"vocoder/blocks/\d+/pw1/b$", (MODEL_AXIS,)),
    (r"vocoder/blocks/\d+/pw2/w$", (MODEL_AXIS, None)),
    # Discriminators (training only): conv stacks shard out-channels like the
    # vocoder rules; conv_post (1 out-channel) falls through to replicated.
    (r"(mpd|msd)/subs/\d+/convs/\d+/w$", (None, None, MODEL_AXIS)),
    (r"(mpd|msd)/subs/\d+/convs/\d+/b$", (MODEL_AXIS,)),
    # Everything else (norms, biases, small projections, MRF stacks): replicated.
    (r".*", ()),
)


def param_spec(path: str) -> Tuple:
    for pattern, spec in _PARAM_RULES:
        if re.match(pattern, path):
            return spec
    return ()


def _path_str(name: str) -> str:
    return name.replace(".", "/")


def axis_sizes(mesh) -> Dict[str, int]:
    """{'data': n, 'model': m} of a DeviceMesh (or such a mapping itself)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def param_shardings(params: nn.Module, mesh) -> Dict[str, Tuple]:
    """{parameter name: axis tuple} via the pattern rules. A dimension that does not
    divide evenly by the mesh axis falls back to replicated for that leaf, with a
    `param_sharding_degraded_to_replicated` warning: across the tree such a
    mismatch silently drops the requested tensor parallelism."""
    sizes = axis_sizes(mesh)
    out = {}
    for name, leaf in params.named_parameters():
        path = _path_str(name)
        spec = param_spec(path)
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            if dim >= leaf.ndim or leaf.shape[dim] % sizes[axis] != 0:
                logger.warning(
                    "param_sharding_degraded_to_replicated", param=path, shape=list(leaf.shape),
                    wanted=str(spec), axis_size=sizes[axis],
                )
                spec = ()
                break
        out[name] = spec
    return out


def _use_mesh(mesh) -> None:
    """Make `mesh`'s 'model' group the one the tensor-parallel layers reduce over."""
    sizes = axis_sizes(mesh)
    tp.set_model_group(
        mesh.get_group(MODEL_AXIS) if sizes[MODEL_AXIS] > 1 else None,
        sizes[MODEL_AXIS], mesh.get_local_rank(MODEL_AXIS),
    )


def shard_params(params: nn.Module, mesh, device=None, specs: Optional[Dict[str, Tuple]] = None) -> nn.Module:
    """A copy of `params` on this rank's device whose sharded leaves hold this
    rank's block (a plain `nn.Parameter` of the local shape, marked with its split
    dimension for `parallel/tp.py`). Leaves already sharded stay as they are.
    `specs` defaults to `param_shardings(params, mesh)`."""
    _use_mesh(mesh)
    specs = specs if specs is not None else param_shardings(params, mesh)
    placed = copy.deepcopy(params)  # Parameter's deepcopy drops attributes: re-mark below
    for (name, old), new in zip(params.named_parameters(), placed.parameters()):
        dim = tp.split_dim(old)
        if dim is not None:
            tp.mark(new, dim)
        elif MODEL_AXIS in specs[name] and tp.model_size() > 1:
            dim = specs[name].index(MODEL_AXIS)
            new.data = tp.own_slice(new.data, dim)
            tp.mark(new, dim)
    return placed.to(device if device is not None else rank_device())


def local_rows(mesh, batch: int) -> slice:
    """This rank's contiguous block of a global batch of `batch` rows, as P('data')
    lays it out."""
    n = axis_sizes(mesh)[DATA_AXIS]
    if batch % n:
        raise ValueError(f"batch {batch} is not divisible by the data axis {n}")
    i = mesh.get_local_rank(DATA_AXIS)
    return slice(i * batch // n, (i + 1) * batch // n)


def gather_params(named: Mapping[str, torch.Tensor], dims: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """Full tensors from this rank's blocks: `dims` maps a sharded name to its split
    dimension (all-gathered over 'model'); the rest are replicated already. Every
    rank of the mesh calls this (it is collective)."""
    return {
        k: tp.all_gather_cat(v, dims[k]) if k in dims and tp.model_size() > 1 else v
        for k, v in named.items()
    }


def split_dims(params: nn.Module) -> Dict[str, int]:
    """{name: split dimension} of `params`' sharded leaves."""
    return {k: tp.split_dim(p) for k, p in params.named_parameters() if tp.split_dim(p) is not None}
