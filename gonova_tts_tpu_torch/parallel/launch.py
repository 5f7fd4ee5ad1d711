"""Start one worker process per mesh position and collect what each returns.

PyTorch drives one device per process, so a sharded run on one host is a group of
worker processes (torch.multiprocessing, spawn). `spawn` starts them, each joins
the process group (NCCL on CUDA, gloo on the CPU) and calls `fn(*args)`; the
workers' return values come back in local-rank order. On one host the store is a
`file://` in a temporary directory, so concurrent groups never contend for a
port; in a multi-host launch the workers join the coordinator of
`init_distributed`'s environment contract instead. On the CPU the workers share
the calling process's intra-op threads (`torch.get_num_threads()`), at least one
each.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist

from . import mesh as pmesh


def spawn(fn: Callable, nprocs: int, device_type: str, *args, multi_host: bool = False) -> List[Any]:
    """`fn(*args)` in `nprocs` workers of one process group (this host's share of
    it when `multi_host`); returns their results, local rank 0 first. A worker's
    exception is raised here."""
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="gonova-workers-")
    try:
        init_method = None if multi_host else "file://" + os.path.join(out, "store")
        threads = max(1, torch.get_num_threads() // nprocs)
        mp.start_processes(
            _run, args=(fn, args, device_type, nprocs, init_method, out, threads), nprocs=nprocs, join=True,
            start_method="spawn",
        )
        return [torch.load(os.path.join(out, f"{i}.pt"), weights_only=False) for i in range(nprocs)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _run(local_rank: int, fn: Callable, args: tuple, device_type: str, local_size: int, init_method, out: str,
         threads: int):
    if device_type == "cpu":
        torch.set_num_threads(threads)
    if init_method is None:
        pmesh.init_distributed(local_rank=local_rank, local_size=local_size, device=device_type)
    else:
        pmesh.init_group(init_method, local_size, local_rank, local_rank, local_size, device_type)
    try:
        torch.save(fn(*args), os.path.join(out, f"{local_rank}.pt"))
    finally:
        if dist.is_initialized():  # `fn` may have left its own group
            dist.destroy_process_group()
