"""The port's C audio runtime (`csrc/audio_runtime.cpp` through `utils/native.py`),
on the CPU.

The library is built with the host compiler into a temporary build directory
(skipped only where there is no C++ compiler) and each entry point is held against
the JAX package's `native` (its own build of the same source) and the port's numpy
forms: `f32_to_i16` within 1 LSB (lrintf against numpy's round), `i16_to_f32`
exact, `crossfade_join` within 1e-6 at overlaps 0, 1 and 64, `audio_stats` within
1e-12, `declick` within 1 float32 ulp, leaving a read-only input untouched. Two
processes, or two threads, building at once leave one loadable library; a kernel's
first load compiles the CUDA sources only; a failed build falls back to numpy and
reports the compiler's message once.
"""

import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gonova_tts_tpu.utils import native as jnative
from gonova_tts_tpu_torch.ops import _build
from gonova_tts_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compiler_or_skip():
    if not any(shutil.which(c) for c in ("c++", "g++")):
        pytest.skip("no host C++ compiler")


@pytest.fixture
def built(tmp_path, monkeypatch):
    """The port's library built into tmp_path/build and loaded as the module's."""
    _compiler_or_skip()
    path = _build.build_host("audio_runtime", build_dir=str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", native._load(path))
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "_TRIED", True)
    return path


@pytest.fixture
def signal():
    rng = np.random.default_rng(0)
    return (0.7 * rng.standard_normal(4099)).astype(np.float32)


def test_built_into_the_build_dir(built, tmp_path):
    assert built == str(tmp_path / "build" / "libaudio_runtime.so") and os.path.exists(built)
    assert native.native_available() and native.native_error() is None
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path / "build"))
    # Never the JAX package's committed library.
    assert os.path.realpath(built) != os.path.realpath(os.path.join(ROOT, "native", "libaudio_runtime.so"))


def test_f32_to_i16(built, signal):
    x = np.concatenate([signal * 2, [0.5 / 32767, 1.5 / 32767, -2.5 / 32767, 1.0, -1.0, 3.0]]).astype(np.float32)
    ours = native.f32_to_i16(x)
    assert ours.dtype == np.int16
    for ref in (jnative.f32_to_i16(x), native.f32_to_i16_numpy(x)):
        assert np.abs(ours.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_i16_to_f32(built):
    pcm = np.arange(-32768, 32768, 7, dtype=np.int16)
    ours = native.i16_to_f32(pcm)
    np.testing.assert_array_equal(ours, jnative.i16_to_f32(pcm))
    np.testing.assert_array_equal(ours, native.i16_to_f32_numpy(pcm))


@pytest.mark.parametrize("overlap", [0, 1, 64])
def test_crossfade_join(built, signal, overlap):
    a, b = signal[:1000], signal[1000:1700]
    ours = native.crossfade_join(a, b, overlap)
    assert ours.shape == (len(a) + len(b) - overlap,)
    np.testing.assert_allclose(ours, jnative.crossfade_join(a, b, overlap), atol=1e-6)
    np.testing.assert_allclose(ours, native.crossfade_join_numpy(a, b, overlap), atol=1e-6)


def test_audio_stats(built, signal):
    ours = native.audio_stats(signal)
    for ref in (jnative.audio_stats(signal), native.audio_stats_numpy(signal)):
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    assert native.audio_stats(np.zeros(0, np.float32)) == (0.0, 0.0)


def test_declick(built, signal):
    ours = native.declick(signal.copy(), 64)
    for ref in (jnative.declick(signal.copy(), 64), native.declick_numpy(signal.copy(), 64)):
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(ours - ref) <= ulp).all()
    writable = signal.copy()
    assert native.declick(writable, 16) is writable and writable[0] == 0.0  # in place
    raw = signal.tobytes()
    read_only = np.frombuffer(raw, np.float32)
    out = native.declick(read_only, 16)  # a copy is faded; the bytes behind the view stay
    assert out is not read_only and out[0] == 0.0
    assert read_only[0] == signal[0] and raw == signal.tobytes()


def test_two_processes_building_at_once(tmp_path):
    _compiler_or_skip()
    build_dir = str(tmp_path / "build")
    code = "import sys; from gonova_tts_tpu_torch.ops import _build; print(_build.build_host('audio_runtime', sys.argv[1]))"
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", code, build_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env, cwd=str(tmp_path), text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert {o.strip() for o, _ in outs} == {os.path.join(build_dir, "libaudio_runtime.so")}
    assert sorted(n for n in os.listdir(build_dir) if n.startswith("libaudio_runtime")) == ["libaudio_runtime.so"]
    lib = native._load(os.path.join(build_dir, "libaudio_runtime.so"))
    out = np.empty(3, np.float32)
    pcm = np.asarray([0, 16384, -32768], np.int16)
    lib.i16_to_f32(pcm.ctypes.data_as(native._I16P), out.ctypes.data_as(native._F32P), 3)
    np.testing.assert_array_equal(out, [0.0, 0.5, -1.0])


def test_two_threads_building_at_once(tmp_path):
    """One process, two threads compiling the same library into one build dir:
    their temporary library and log files are apart, both return the library."""
    import threading

    _compiler_or_skip()
    build_dir = str(tmp_path / "build")
    results, errors = [], []

    def build():
        try:
            results.append(_build._compile({"audio_runtime": _build._host_job(_build._sources(".cpp")["audio_runtime"])},
                                           build_dir))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(results) == 2
    assert sorted(os.listdir(build_dir)) == ["audio_runtime.log", "libaudio_runtime.so"]
    native._load(os.path.join(build_dir, "libaudio_runtime.so"))


def test_a_kernel_load_builds_only_the_cuda_sources(monkeypatch, tmp_path):
    """`load` (every CUDA op's first call) compiles the stale .cu sources only; the
    host library is `build_all`'s (chip_smoke's build phase) and `build_host`'s."""
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))  # everything is stale
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_cxx", lambda: "c++")
    seen = []
    monkeypatch.setattr(_build, "_compile", lambda jobs, build_dir: seen.append(sorted(jobs)) or {})
    cuda = sorted(_build._sources())
    _build.build_kernels()
    _build.build_all()
    assert seen == [cuda, sorted(cuda + ["audio_runtime"])]
    assert "audio_runtime" not in cuda


def test_first_use_builds_and_a_failed_build_reports(tmp_path, monkeypatch, caplog, signal):
    _compiler_or_skip()
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "first"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.native_available()  # built at first use, into the build dir
    assert os.path.exists(tmp_path / "first" / "libaudio_runtime.so")

    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "broken"))
    monkeypatch.setattr(_build, "CXX_FLAGS", _build.CXX_FLAGS + ["-include", "no/such/header.h"])
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    with caplog.at_level(logging.WARNING, logger="gonova_tts_tpu_torch.native"):
        assert not native.native_available()
        assert native.f32_to_i16(signal).tolist() == native.f32_to_i16_numpy(signal).tolist()
        native.audio_stats(signal)
    assert "no/such/header.h" in native.native_error()
    assert len([r for r in caplog.records if "C audio runtime unavailable" in r.getMessage()]) == 1

