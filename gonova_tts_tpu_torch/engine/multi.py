"""Data-parallel serving: one engine, N devices, the batch split over them.

Counterpart of `gonova_tts_tpu/engine/multi.py`. The JAX engine replicates its
parameters over a ('data',) mesh and lets XLA partition each compiled graph; here
every device holds its own replica (a deep copy, so each has its own kernel-weight
memos, `layers.cached`) and runs its contiguous block of batch rows, as
`P('data')` lays them out: rank i takes rows [i·b/n, (i+1)·b/n). The engine
enqueues every shard before it reads any back, so the devices overlap; all shards
are launched from one Python thread.

`local_devices` is the one place the device list comes from (the port's
`jax.devices()`). Batch buckets are rounded up to a multiple of the device count
so every device gets equal work.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch


def local_devices(device) -> List[torch.device]:
    """Every device of `device`'s type on this host: each CUDA card, or the CPU."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class DataParallel:
    """`n_devices` replicas (default: every device of `devices`, which defaults to
    `local_devices("cuda")`)."""

    def __init__(self, n_devices: Optional[int] = None, devices: Optional[Sequence[torch.device]] = None):
        devices = list(devices if devices is not None else local_devices("cuda"))
        n = n_devices or len(devices)
        if n > len(devices):
            raise ValueError(f"requested {n} devices, have {len(devices)}")
        self.n = n
        self.devices = devices[:n]

    def place_params(self, params: torch.nn.Module) -> List[torch.nn.Module]:
        """One replica per device: a deep copy of `params` moved there."""
        return [copy.deepcopy(params).to(dev) for dev in self.devices]

    def shard_rows(self, arr: np.ndarray) -> List[np.ndarray]:
        """Split a batch-leading array into n equal contiguous row blocks."""
        if len(arr) % self.n:
            raise ValueError(f"batch {len(arr)} is not a multiple of {self.n} devices")
        return np.split(arr, self.n)

    def round_batch(self, b: int) -> int:
        """Smallest multiple of the device count >= b."""
        return -(-b // self.n) * self.n
