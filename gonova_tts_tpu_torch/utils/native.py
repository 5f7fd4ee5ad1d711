"""Host-side audio helpers: the C audio runtime through ctypes, numpy where it is absent.

Counterpart of `gonova_tts_tpu/utils/native.py`. The library is the port's own
build of `gonova_tts_tpu_torch/csrc/audio_runtime.cpp` (`build/libaudio_runtime.so`,
made by `ops/_build.py` with the host compiler: by `build_all()` with the kernels,
or here at first use when it is missing or stale). Every entry point has a numpy
form, used when the library cannot be built or loaded; such a failure is logged
once, with the compiler's message, and `native_available()` / `native_error()`
report it. The native path removes the per-chunk numpy overhead on the service's
send and validate paths.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("gonova_tts_tpu_torch.native")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None
_TRIED = False

_F32P = ctypes.POINTER(ctypes.c_float)
_I16P = ctypes.POINTER(ctypes.c_int16)


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.f32_to_i16.argtypes = [_F32P, _I16P, ctypes.c_int64]
    lib.f32_to_i16.restype = ctypes.c_int64
    lib.i16_to_f32.argtypes = [_I16P, _F32P, ctypes.c_int64]
    lib.i16_to_f32.restype = ctypes.c_int64
    lib.crossfade_join.argtypes = [_F32P, ctypes.c_int64, _F32P, ctypes.c_int64, ctypes.c_int64, _F32P]
    lib.crossfade_join.restype = ctypes.c_int64
    lib.audio_stats.argtypes = [
        _F32P, ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.audio_stats.restype = None
    lib.declick.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int64]
    lib.declick.restype = None
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it first if needed; None (logged once) when it
    cannot be built or loaded."""
    global _LIB, _ERROR, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            from ..ops import _build

            try:
                _LIB = _load(_build.build_host("audio_runtime"))
            except (OSError, RuntimeError) as e:
                _ERROR = str(e)
                logger.warning("C audio runtime unavailable, using the numpy forms: %s", _ERROR)
            _TRIED = True
    return _LIB


def native_available() -> bool:
    return _lib() is not None


def native_error() -> Optional[str]:
    """Why the library is not in use (the compiler's or the loader's message), or
    None when it is loaded."""
    _lib()
    return _ERROR


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


# ---------------------------------------------------------------- numpy forms
# What each entry point computes where the library is absent; chip_smoke.py and the
# tests hold the library against them.


def f32_to_i16_numpy(audio: np.ndarray) -> np.ndarray:
    return (np.clip(audio, -1.0, 1.0) * 32767.0).round().astype(np.int16)


def i16_to_f32_numpy(pcm: np.ndarray) -> np.ndarray:
    return pcm.astype(np.float32) / 32768.0


def crossfade_join_numpy(a: np.ndarray, b: np.ndarray, overlap: int) -> np.ndarray:
    if overlap == 0:
        return np.concatenate([a, b])
    t = np.linspace(0.0, np.pi / 2, overlap, dtype=np.float32)
    seam = a[-overlap:] * np.cos(t) ** 2 + b[:overlap] * np.sin(t) ** 2
    return np.concatenate([a[:-overlap], seam, b[overlap:]])


def audio_stats_numpy(audio: np.ndarray) -> Tuple[float, float]:
    """Accumulated in float64, as the library does (an f32 mean is ~1e-8 off)."""
    if audio.size == 0:
        return 0.0, 0.0  # np.mean of an empty array is nan
    return float(np.mean(np.square(audio, dtype=np.float64))), float(np.max(np.abs(audio)))


def declick_numpy(audio: np.ndarray, n_fade: int) -> np.ndarray:
    n_fade = min(n_fade, len(audio) // 2)
    if n_fade > 0:
        w = 0.5 - 0.5 * np.cos(np.pi * np.arange(n_fade) / n_fade)
        audio[:n_fade] *= w
        audio[-n_fade:] *= w[::-1]
    return audio


# ---------------------------------------------------------------- entry points


def f32_to_i16(audio: np.ndarray) -> np.ndarray:
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    lib = _lib()
    if lib is None:
        return f32_to_i16_numpy(audio)
    out = np.empty(audio.shape, np.int16)
    lib.f32_to_i16(_f32(audio), out.ctypes.data_as(_I16P), audio.size)
    return out


def i16_to_f32(pcm: np.ndarray) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    lib = _lib()
    if lib is None:
        return i16_to_f32_numpy(pcm)
    out = np.empty(pcm.shape, np.float32)
    lib.i16_to_f32(pcm.ctypes.data_as(_I16P), _f32(out), pcm.size)
    return out


def crossfade_join(a: np.ndarray, b: np.ndarray, overlap: int) -> np.ndarray:
    """Join two clips with an equal-power (cos^2 / sin^2) crossfade of `overlap`
    samples; returns length len(a) + len(b) - overlap."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    overlap = max(int(min(overlap, len(a), len(b))), 0)
    lib = _lib()
    if lib is None:
        return crossfade_join_numpy(a, b, overlap)
    out = np.empty((len(a) + len(b) - overlap,), np.float32)
    if lib.crossfade_join(_f32(a), len(a), _f32(b), len(b), overlap, _f32(out)) < 0:
        raise ValueError("invalid crossfade arguments")
    return out


def audio_stats(audio: np.ndarray) -> Tuple[float, float]:
    """(mean_square_energy, peak_abs): the voice-validation scan in one pass."""
    audio = np.ascontiguousarray(audio, np.float32)
    lib = _lib()
    if lib is None:
        return audio_stats_numpy(audio)
    ms, pk = ctypes.c_double(), ctypes.c_double()
    lib.audio_stats(_f32(audio), audio.size, ctypes.byref(ms), ctypes.byref(pk))
    return ms.value, pk.value


def declick(audio: np.ndarray, n_fade: int = 64) -> np.ndarray:
    """Half-Hann fade-in/out. Mutates in place when the input is a writable
    contiguous float32 array (and returns it); otherwise works on a copy and
    returns that, so callers must use the return value. The writability rule
    matters: an `np.frombuffer(bytes)` array is a read-only view of the bytes, and
    writing through the library's pointer would corrupt every other reference to
    them."""
    audio = np.require(audio, np.float32, ["C", "W"])
    lib = _lib()
    if lib is None:
        return declick_numpy(audio, n_fade)
    lib.declick(_f32(audio), audio.size, n_fade)
    return audio
