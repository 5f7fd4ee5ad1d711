"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles to `build/lib<name>.so` at the repo root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

All stale sources compile at once, one nvcc process each, on the first call of any
kernel (or of `build_all`). A library is stale when it is missing or older than a
file in `csrc/`. The C functions take pointers as `c_void_p`, the current CUDA
stream last, and return `cudaGetLastError()`; `check` turns a non-zero code into
an exception; every call runs under `launch_on(tensor.device)`. Nothing here runs
at import time: the CPU tests import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def _sources() -> Dict[str, str]:
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    }


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def build_all() -> Dict[str, float]:
    """Compile every stale source in parallel; returns seconds per compiled source
    (empty when all libraries are current). Raises with nvcc's output on failure."""
    newest = max(os.path.getmtime(p) for p in glob.glob(os.path.join(CSRC, "*")))
    stale = {
        name: src for name, src in _sources().items()
        if not os.path.exists(_lib_path(name)) or os.path.getmtime(_lib_path(name)) < newest
    }
    if not stale:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, src in stale.items():
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        log = open(os.path.join(BUILD, f"{name}.log"), "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=log, stderr=subprocess.STDOUT
        )
        procs[name] = (proc, tmp, log)
    seconds, failed = {}, []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, _lib_path(name))
        else:
            with open(log.name) as fh:
                failed.append(f"nvcc {name}.cu exited {rc}:\n{fh.read()[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building what is stale first.
    `signatures` maps each C function to its argtypes (all return an int)."""
    with _LOCK:
        if name not in _LIBS:
            build_all()
            lib = ctypes.CDLL(_lib_path(name))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@contextlib.contextmanager
def launch_on(device):
    """Make `device` the current CUDA device for a launch and yield its current
    stream. The runtime launches on the current device, whatever the tensors'
    device: a tensor on cuda:1 launched while cuda:0 is current fails with an
    invalid handle, and a per-device attribute (the shared-memory opt-in) would be
    set on the wrong card."""
    import torch

    with torch.cuda.device(device):
        yield ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
