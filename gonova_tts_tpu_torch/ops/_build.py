"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles to `build/lib<name>.so` at the repo root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

and each host source `csrc/<name>.cpp` (the audio runtime) with the host compiler:

    c++ -O3 -fPIC -shared -std=c++17

The stale CUDA sources compile at once, one nvcc process each, on the first call of
any kernel (`build_kernels`); `build_all` compiles the stale CUDA and host sources
together; `build_host` builds one host library alone, which needs no nvcc, at the
first use of that library. A CUDA library is stale when it is missing or older than a CUDA
source or header in `csrc/`, a host library when it is missing or older than its
source. Every library is written to a temporary file and moved into place, so
processes that build at once leave one whole library. The kernels' C functions
take pointers as `c_void_p`, the current CUDA stream last, and return
`cudaGetLastError()`; `check` turns a non-zero code into an exception; every call
runs under `launch_on(tensor.device)`. Nothing here runs at import time: the CPU
tests import every module.
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
from typing import Dict, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
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


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")


def _sources(ext: str = ".cu") -> Dict[str, str]:
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(CSRC, "*" + ext)))
    }


def _lib_path(name: str, build_dir: Optional[str] = None) -> str:
    return os.path.join(build_dir or BUILD, f"lib{name}.so")


def _stale(name: str, newer_than: float, build_dir: Optional[str] = None) -> bool:
    lib = _lib_path(name, build_dir)
    return not os.path.exists(lib) or os.path.getmtime(lib) < newer_than


def _compile(jobs: Dict[str, List[str]], build_dir: str) -> Dict[str, float]:
    """Run one compiler process per library (`jobs`: name → command without its
    output), all at once; each output goes to a temporary file that is moved into
    place. Returns seconds per library; raises with the compilers' output."""
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, cmd in jobs.items():
        tmp = _lib_path(name, build_dir) + f".{os.getpid()}.{threading.get_ident()}.tmp"
        log = open(os.path.join(build_dir, f"{name}.log.{os.getpid()}.{threading.get_ident()}"), "w+")
        proc = subprocess.Popen([*cmd, "-o", tmp], stdout=log, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, log)
    seconds, failed = {}, []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.seek(0)
        text = log.read()
        log.close()
        os.replace(log.name, os.path.join(build_dir, f"{name}.log"))
        if rc == 0:
            os.replace(tmp, _lib_path(name, build_dir))
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"{os.path.basename(cmd[0])} {name} exited {rc}:\n{text[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def _host_job(src: str) -> List[str]:
    return [_cxx(), *CXX_FLAGS, src]


def _kernel_jobs() -> Dict[str, List[str]]:
    newest = max(os.path.getmtime(p) for p in glob.glob(os.path.join(CSRC, "*")) if not p.endswith(".cpp"))
    return {name: [_nvcc(), *NVCC_FLAGS, src] for name, src in _sources().items() if _stale(name, newest)}


def build_kernels() -> Dict[str, float]:
    """Compile every stale CUDA source in parallel; returns seconds per compiled
    source (empty when all are current). Raises with nvcc's output on failure."""
    jobs = _kernel_jobs()
    return _compile(jobs, BUILD) if jobs else {}


def build_all() -> Dict[str, float]:
    """`build_kernels` and every stale host source, all compilers at once."""
    jobs = _kernel_jobs()
    jobs.update({
        name: _host_job(src) for name, src in _sources(".cpp").items()
        if _stale(name, os.path.getmtime(src))
    })
    return _compile(jobs, BUILD) if jobs else {}


def build_host(name: str, build_dir: Optional[str] = None) -> str:
    """Build `csrc/<name>.cpp` with the host compiler if its library is stale, and
    return the library's path. Raises with the compiler's output on failure."""
    src = _sources(".cpp")[name]
    build_dir = build_dir or BUILD
    if _stale(name, os.path.getmtime(src), build_dir):
        _compile({name: _host_job(src)}, build_dir)
    return _lib_path(name, build_dir)


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building what is stale first.
    `signatures` maps each C function to its argtypes (all return an int)."""
    with _LOCK:
        if name not in _LIBS:
            build_kernels()
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
