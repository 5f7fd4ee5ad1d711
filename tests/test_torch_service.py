"""The port's service core, on the CPU: WAV codec, host audio helpers, rate limiter,
queue manager, voice manager, embedding cache, dynamic batcher and the
StreamingSynthesizer facade.

These modules are the port's own copies of JAX-free modules of gonova_tts_tpu, so
the cases are those of tests/test_wavio.py, tests/test_service_units.py,
tests/test_native.py, tests/test_engine.py and tests/test_synthesizer_facade.py,
pointed at the copies; where both packages can run the same input, the results are
held equal. The batcher cases drive a stub engine with explicit admission windows
(a full batch or a stop() ends a window, never the clock).
"""

import asyncio
import base64
import dataclasses
import io
import os
import struct

import numpy as np
import pytest
import torch

from gonova_tts_tpu.utils import native as jnative
from gonova_tts_tpu.utils import wavio as jwavio
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import DynamicBatcher, TTSEngine, VoiceEmbeddingCache
from gonova_tts_tpu_torch.service import (
    RateLimiter,
    StreamingSynthesizer,
    TTSQueueManager,
    VoiceManager,
    sanitize_voice_id,
    validate_reference_audio,
)
from gonova_tts_tpu_torch.text import text_to_ids
from gonova_tts_tpu_torch.utils import Tracer, get_logger, native, wavio, write_wav

DEFAULT_VOICE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "default_voice.wav")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores: torch's own thread pool (8 spinning
    threads per worker) would starve the other workers' tests."""
    torch.set_num_threads(1)


# ---------------------------------------------------------------- wav codec


def make_sine(sr=24000, secs=0.5, freq=440.0):
    t = np.arange(int(sr * secs)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def test_roundtrip_float32():
    x = make_sine()
    data = wavio.write_wav(None, x, 24000, dtype="float32")
    y, sr = wavio.read_wav(data)
    assert sr == 24000
    np.testing.assert_allclose(y, x, atol=1e-7)


def test_roundtrip_int16():
    x = make_sine()
    data = wavio.write_wav(None, x, 16000, dtype="int16")
    y, sr = wavio.read_wav(data)
    assert sr == 16000
    np.testing.assert_allclose(y, x, atol=1.0 / 32767)


def test_roundtrip_stereo():
    x = np.stack([make_sine(), make_sine(freq=220.0)], axis=1)
    data = wavio.write_wav(None, x, 44100, dtype="int16")
    y, sr = wavio.read_wav(data)
    assert y.shape == x.shape
    assert sr == 44100


def test_stdlib_wave_interop(tmp_path):
    """Our int16 output must be readable by the stdlib wave module and vice versa."""
    import wave

    x = make_sine(sr=8000)
    path = str(tmp_path / "a.wav")
    wavio.write_wav(path, x, 8000, dtype="int16")
    with wave.open(path) as w:
        assert w.getframerate() == 8000
        assert w.getnchannels() == 1
        assert w.getsampwidth() == 2
        raw = w.readframes(w.getnframes())
    ours, _ = wavio.read_wav(path)
    theirs = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    # write scale is 32767 on write, 32768 on read: match against raw bytes directly
    np.testing.assert_allclose(ours, theirs, atol=0)


def test_pcm24():
    # Hand-assemble a 24-bit PCM file.
    samples = np.array([0, 1 << 22, -(1 << 22), (1 << 23) - 1], dtype=np.int64)
    payload = b"".join(struct.pack("<i", int(s))[:3] for s in samples)
    header = (
        b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
        b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 48000, 48000 * 3, 3, 24)
        + b"data" + struct.pack("<I", len(payload))
    )
    y, sr = wavio.read_wav(header + payload)
    assert sr == 48000
    np.testing.assert_allclose(y, samples / 8388608.0, atol=1e-12)


def test_reject_garbage():
    with pytest.raises(wavio.WavError):
        wavio.read_wav(b"not a wav file at all")
    with pytest.raises(wavio.WavError):
        wavio.read_wav(b"RIFF\x00\x00\x00\x00WAVE")  # no fmt/data


def test_write_to_buffer():
    buf = io.BytesIO()
    x = make_sine()
    wavio.write_wav(buf, x, 24000)
    y, sr = wavio.read_wav(buf.getvalue())
    assert sr == 24000 and len(y) == len(x)


def test_reads_default_voice_asset():
    """The repo's reference voice decodes: 16-bit PCM, 24 kHz, mono, 5 s."""
    y, sr = wavio.read_wav(DEFAULT_VOICE)
    assert sr == 24000
    assert y.ndim == 1
    assert abs(len(y) / sr - 5.0) < 0.01
    assert float(np.abs(y).max()) <= 1.0


def test_malformed_wavs_raise_waverror_not_raw_exceptions():
    """Regression: truncated fmt chunks raised struct.error and sample_rate=0
    parsed fine (dividing by zero downstream) — all must be WavError so the
    voice-registration handler classifies them as invalid payloads."""
    import struct

    import pytest

    from gonova_tts_tpu_torch.utils.wavio import WavError, read_wav

    truncated_fmt = (
        b"RIFF" + struct.pack("<I", 100) + b"WAVE" + b"fmt " + struct.pack("<I", 16) + b"\x01\x00"
    )
    with pytest.raises(WavError):
        read_wav(truncated_fmt)

    fmt0 = struct.pack("<HHIIHH", 1, 1, 0, 0, 2, 16)
    sr_zero = (
        b"RIFF" + struct.pack("<I", 36) + b"WAVE"
        + b"fmt " + struct.pack("<I", 16) + fmt0
        + b"data" + struct.pack("<I", 4) + b"\x00" * 4
    )
    with pytest.raises(WavError):
        read_wav(sr_zero)

    # Odd-length 16-bit data (truncated upload): trimmed to whole samples, no crash.
    fmt = struct.pack("<HHIIHH", 1, 1, 24000, 48000, 2, 16)
    odd = (
        b"RIFF" + struct.pack("<I", 36) + b"WAVE"
        + b"fmt " + struct.pack("<I", 16) + fmt
        + b"data" + struct.pack("<I", 3) + b"\x00" * 3
    )
    audio, sr = read_wav(odd)
    assert sr == 24000 and len(audio) == 1


def test_write_wav_rejects_riff_overflow_cleanly():
    """Regression: size-field overflow escaped as a bare struct.error (and only
    after materializing the payload); it must be a WavError with limits named."""
    import numpy as np
    import pytest

    from gonova_tts_tpu_torch.utils.wavio import WavError, write_wav

    with pytest.raises(WavError, match="65535 channels|WAV limits"):
        write_wav(None, np.zeros((4, 70000), np.float32), 24000)


# ---------------------------------------------------------------- both codecs, same bytes


def test_wav_codec_agrees_with_the_jax_package(rng):
    audio = (0.5 * rng.standard_normal((2400, 2))).clip(-1, 1).astype(np.float32)
    for dtype in ("int16", "float32"):
        ours = wavio.write_wav(None, audio, 24000, dtype=dtype)
        assert ours == jwavio.write_wav(None, audio, 24000, dtype=dtype)
        a, sr_a = wavio.read_wav(ours)
        b, sr_b = jwavio.read_wav(ours)
        assert sr_a == sr_b == 24000
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- host audio helpers


def test_native_helpers_agree_with_the_jax_package(rng):
    a = rng.standard_normal(500).astype(np.float32)
    b = rng.standard_normal(300).astype(np.float32)
    np.testing.assert_array_equal(native.f32_to_i16(a * 2), jnative.f32_to_i16(a * 2))
    pcm = native.f32_to_i16(a)
    np.testing.assert_array_equal(native.i16_to_f32(pcm), jnative.i16_to_f32(pcm))
    for overlap in (0, 1, 64, 1000):
        ours, theirs = native.crossfade_join(a, b, overlap), jnative.crossfade_join(a, b, overlap)
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, atol=1e-6)
    np.testing.assert_allclose(native.audio_stats(a), jnative.audio_stats(a), rtol=1e-6)
    assert native.audio_stats(np.zeros(0, np.float32)) == (0.0, 0.0)
    np.testing.assert_allclose(native.declick(a.copy(), 32), jnative.declick(a.copy(), 32), atol=1e-7)
    read_only = np.frombuffer(a.tobytes(), np.float32)
    out = native.declick(read_only, 16)  # a read-only view: a copy is faded, the bytes stay
    assert out is not read_only and out[0] == 0.0 and read_only[0] == a[0]


def test_crossfade_join_constant_and_empty():
    a = np.ones(100, np.float32)
    out = native.crossfade_join(a, a, 20)
    assert out.shape == (180,)
    np.testing.assert_allclose(out, 1.0, atol=1e-6)  # cos^2 + sin^2
    np.testing.assert_array_equal(native.crossfade_join(np.zeros(0, np.float32), a, 20), a)


def test_get_logger_emits_json_lines(capsys):
    import json
    import logging

    log = get_logger("gonova.test_torch_service")
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    from gonova_tts_tpu_torch.utils import jsonlog

    handler.setFormatter(jsonlog._JsonFormatter())
    logging.getLogger("gonova.test_torch_service").addHandler(handler)
    logging.getLogger("gonova.test_torch_service").setLevel(logging.INFO)
    log.info("voice_registered", voice_id="v1", seconds=4.0)
    line = json.loads(stream.getvalue().strip().splitlines()[-1])
    assert line["event"] == "voice_registered" and line["voice_id"] == "v1" and line["level"] == "info"


# ---------------------------------------------------------------- rate limiter


def test_rate_limiter_allows_under_limit():
    rl = RateLimiter(max_requests=3, window=60)
    assert all(rl.check("a") for _ in range(3))
    assert not rl.check("a")
    assert rl.check("b")  # independent per client


def test_rate_limiter_window_expiry(monkeypatch):
    import time as _time

    rl = RateLimiter(max_requests=2, window=10)
    now = [1000.0]
    monkeypatch.setattr(_time, "time", lambda: now[0])
    assert rl.check("x") and rl.check("x") and not rl.check("x")
    now[0] += 11.0
    assert rl.check("x")  # old entries expired


def test_rate_limiter_prune():
    rl = RateLimiter(max_requests=2, window=0.0)
    rl.check("gone")
    rl.prune()
    assert "gone" not in rl._requests


# ---------------------------------------------------------------- voice id / validation


def test_sanitize_voice_id():
    assert sanitize_voice_id("../../etc/passwd") == "etcpasswd"
    assert sanitize_voice_id("my_voice-1") == "my_voice-1"
    assert len(sanitize_voice_id("a" * 200)) == 64
    with pytest.raises(ValueError):
        sanitize_voice_id("!!!")


def _tone(secs=5.0, sr=24000, amp=0.5, noise=0.02):
    rng = np.random.default_rng(0)
    t = np.arange(int(secs * sr)) / sr
    return (amp * np.sin(2 * np.pi * 220 * t) + noise * rng.standard_normal(len(t))).astype(
        np.float32
    )


def test_validate_good_audio():
    assert validate_reference_audio(_tone(), 24000)["valid"]


@pytest.mark.parametrize(
    "audio,sr,reason_part",
    [
        (_tone(secs=1.0), 24000, "Too short"),
        (_tone(secs=12.0), 24000, "Too long"),
        (_tone(amp=0.05, noise=0.001), 24000, "too quiet"),
        (np.clip(_tone(amp=3.0), -1, 1), 24000, "clipped"),
    ],
)
def test_validate_rejections(audio, sr, reason_part):
    verdict = validate_reference_audio(audio, sr)
    assert not verdict["valid"]
    assert reason_part.lower() in verdict["reason"].lower()


def test_validate_poor_snr():
    # Constant-ish amplitude noise: p90/p10 close to 1 → rejected as noisy.
    rng = np.random.default_rng(0)
    audio = (0.4 * np.sign(rng.standard_normal(24000 * 5))).astype(np.float32)
    audio += 0.01 * rng.standard_normal(len(audio)).astype(np.float32)
    verdict = validate_reference_audio(audio, 24000)
    assert not verdict["valid"]
    assert "noisy" in verdict["reason"].lower()


# ---------------------------------------------------------------- voice manager


def test_voice_manager_register_and_lookup(tmp_path):
    async def run():
        vm = VoiceManager(cache_dir=str(tmp_path / "voices"))
        wav_bytes = write_wav(None, _tone(), 24000)
        b64 = base64.b64encode(wav_bytes).decode()
        path = await vm.register_voice("alice", b64, description="test voice")
        assert path.endswith("alice.wav")
        assert await vm.get_voice("alice") == path
        voices = vm.list_voices()
        assert [v["voice_id"] for v in voices] == ["alice"]
        assert voices[0]["description"] == "test voice"
        # Disk-only lookup (fresh manager on same dir).
        vm2 = VoiceManager(cache_dir=str(tmp_path / "voices"))
        assert (await vm2.get_voice("alice")).endswith("alice.wav")
        assert await vm2.get_voice("missing") is None
        stats = vm2.get_stats()
        assert stats["total_voices"] == 1
        return True

    assert asyncio.run(run())


def test_voice_manager_cache_key_is_sanitized(tmp_path):
    """Two raw ids sanitizing to the same file must share one cache entry, and
    list_voices must report is_cached correctly after an aliased lookup."""

    async def run():
        vm = VoiceManager(cache_dir=str(tmp_path / "voices"))
        b64 = base64.b64encode(write_wav(None, _tone(), 24000)).decode()
        await vm.register_voice("alice", b64)
        vm2 = VoiceManager(cache_dir=str(tmp_path / "voices"))
        # 'al/ice' sanitizes to 'alice' → same entry, keyed by the safe id.
        p1 = await vm2.get_voice("al/ice")
        p2 = await vm2.get_voice("alice")
        assert p1 == p2
        assert list(vm2.voice_cache) == ["alice"]
        assert vm2.list_voices()[0]["is_cached"] is True
        return True

    assert asyncio.run(run())


def test_voice_manager_rejects_bad_payloads(tmp_path):
    async def run():
        vm = VoiceManager(cache_dir=str(tmp_path / "voices"))
        with pytest.raises(ValueError):
            await vm.register_voice("bob", "not-base64!!!")
        with pytest.raises(ValueError):
            await vm.register_voice("bob", base64.b64encode(b"garbage").decode())
        short = base64.b64encode(write_wav(None, _tone(secs=0.5), 24000)).decode()
        with pytest.raises(ValueError):
            await vm.register_voice("bob", short)
        with pytest.raises(ValueError):
            await vm.register_voice("###", base64.b64encode(write_wav(None, _tone(), 24000)).decode())
        assert vm.list_voices() == []
        return True

    assert asyncio.run(run())


def test_voice_manager_path_traversal_blocked(tmp_path):
    async def run():
        vm = VoiceManager(cache_dir=str(tmp_path / "voices"))
        b64 = base64.b64encode(write_wav(None, _tone(), 24000)).decode()
        path = await vm.register_voice("../../evil", b64)
        # Stored inside the voices dir, dots stripped.
        assert str(tmp_path / "voices") in path
        assert ".." not in path
        return True

    assert asyncio.run(run())


# ---------------------------------------------------------------- queue manager


def test_queue_manager_roundtrip_and_metrics():
    async def run():
        qm = TTSQueueManager(input_queue_size=2, output_queue_size=4)
        assert await qm.enqueue_request("c1", "hello")
        req = await qm.get_next_request(timeout=0.1)
        assert req.text == "hello" and req.voice_id == "default"
        assert req.chunk_size == 50 and req.exaggeration == 0.5 and req.streaming
        await qm.mark_request_done()

        out_q = qm.register_connection("c1")
        assert await qm.enqueue_audio_chunk("c1", b"xx", 0)
        assert await qm.enqueue_audio_chunk("c1", b"", 1, is_final=True)
        first = out_q.get_nowait()
        assert first.audio_data == b"xx" and not first.is_final
        final = out_q.get_nowait()
        assert final.is_final and final.chunk_id == 1 and final.sample_rate == 24000

        m = qm.get_metrics()
        for key in (
            "requests_received",
            "requests_processed",
            "requests_dropped",
            "chunks_sent",
            "active_connections",
            "input_queue_size",
            "output_queues_count",
            "total_output_queue_items",
        ):
            assert key in m
        assert m["requests_received"] == 1 and m["requests_processed"] == 1
        assert m["chunks_sent"] == 2
        return True

    assert asyncio.run(run())


def test_queue_manager_input_drop_on_full():
    async def run():
        qm = TTSQueueManager(input_queue_size=1)
        assert await qm.enqueue_request("c1", "one")
        ok = await qm.enqueue_request("c1", "two", timeout=0.05)
        assert not ok
        assert qm.metrics["requests_dropped"] == 1
        return True

    assert asyncio.run(run())


def test_queue_manager_output_drop_on_full():
    async def run():
        qm = TTSQueueManager(output_queue_size=1)
        qm.register_connection("c1")
        assert await qm.enqueue_audio_chunk("c1", b"a", 0)
        ok = await qm.enqueue_audio_chunk("c1", b"b", 1)
        assert not ok  # queue full, 0.1 s retry elapses, dropped
        # Unknown connection: dropped silently.
        assert not await qm.enqueue_audio_chunk("ghost", b"x", 0)
        return True

    assert asyncio.run(run())


def test_queue_manager_unregister_drains():
    async def run():
        qm = TTSQueueManager()
        q = qm.register_connection("c1")
        await qm.enqueue_audio_chunk("c1", b"a", 0)
        qm.unregister_connection("c1")
        assert q.empty()
        assert qm.get_metrics()["active_connections"] == 0
        qm.unregister_connection("c1")  # idempotent
        return True

    assert asyncio.run(run())


def test_queue_manager_wait_until_empty():
    async def run():
        qm = TTSQueueManager()
        assert await qm.wait_until_empty(timeout=0.6)
        await qm.enqueue_request("c1", "x")
        assert not await qm.wait_until_empty(timeout=0.6)
        return True

    assert asyncio.run(run())


def test_queue_manager_final_chunk_not_dropped_under_brief_backpressure():
    """Control frames (is_final / negative chunk ids) must survive a full output
    queue that drains within the 5 s control bound — dropping synthesis_complete
    strands the client."""

    async def run():
        qm = TTSQueueManager(output_queue_size=1)
        q = qm.register_connection("c1")
        assert await qm.enqueue_audio_chunk("c1", b"a", 0)

        async def drain_soon():
            await asyncio.sleep(0.5)  # past the 0.1 s audio-drop bound
            q.get_nowait()

        drainer = asyncio.ensure_future(drain_soon())
        ok = await qm.enqueue_audio_chunk("c1", b"", 1, is_final=True)
        await drainer
        assert ok  # the final marker waited out the backpressure instead of dropping
        return True

    assert asyncio.run(run())


def test_queue_manager_wait_until_empty_counts_in_flight():
    """A request pulled by a worker but not yet marked done is in NEITHER queue —
    the drain check must not report empty (shutdown would cancel mid-synthesis)."""

    async def run():
        qm = TTSQueueManager()
        await qm.enqueue_request("c1", "x")
        req = await qm.get_next_request()
        assert req is not None
        assert not await qm.wait_until_empty(timeout=0.6)  # in flight
        await qm.mark_request_done()
        assert await qm.wait_until_empty(timeout=0.6)
        return True

    assert asyncio.run(run())


def test_voice_manager_eviction_bounds_cache_and_metadata(tmp_path):
    """Regression: eviction ranked ALL metadata (including already-evicted ids), so
    after the first cycle it evicted nothing and metadata grew without bound."""
    vm = VoiceManager(cache_dir=str(tmp_path), max_cached=4)

    async def run():
        sr = 24000
        t = np.arange(int(4.0 * sr)) / sr
        rng = np.random.default_rng(0)
        audio = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(len(t))).astype(
            np.float32
        )
        b64 = base64.b64encode(write_wav(None, audio, sr)).decode()
        for i in range(12):
            assert await vm.register_voice(f"v{i:02d}", b64)
        # Repeated eviction cycles must keep BOTH structures bounded.
        assert len(vm.voice_cache) <= vm.max_cached
        assert len(vm.voice_metadata) <= vm.max_cached
        # The newest registrations survive.
        assert "v11" in vm.voice_cache
        return True

    assert asyncio.run(run())


def test_voice_manager_generation_and_atomic_rewrite(tmp_path):
    """Re-registration bumps the generation (stale-embedding guard) and replaces
    the WAV atomically (no .tmp left behind, file always parseable)."""
    async def run():
        vm = VoiceManager(cache_dir=str(tmp_path / "voices"))
        b64 = base64.b64encode(write_wav(None, _tone(), 24000)).decode()
        assert vm.generation_of("bob") == 0
        await vm.register_voice("bob", b64)
        g1 = vm.generation_of("bob")
        await vm.register_voice("bob", b64)
        assert vm.generation_of("bob") == g1 + 1
        leftovers = list((tmp_path / "voices").glob("*.tmp"))
        assert leftovers == []
        return True

    assert asyncio.run(run())


def test_voice_manager_disk_lookups_respect_cache_bound(tmp_path):
    """Regression: disk-found voices were inserted into voice_cache without ever
    triggering cleanup (unbounded growth) and with created_at=0 (always evicted
    first regardless of recency)."""
    async def run():
        vdir = tmp_path / "voices"
        vdir.mkdir()
        wav_bytes = write_wav(None, _tone(), 24000)
        for i in range(8):
            (vdir / f"v{i}.wav").write_bytes(wav_bytes)
        vm = VoiceManager(cache_dir=str(vdir), max_cached=4)
        for i in range(8):
            assert await vm.get_voice(f"v{i}") is not None
        assert len(vm.voice_cache) <= 4
        # Evicted-but-on-disk voices still resolve (disk fallback).
        assert await vm.get_voice("v0") is not None
        # Disk-loaded entries carry a real created_at (not the always-evict 0).
        for vid in vm.voice_cache:
            assert vm.voice_metadata[vid]["created_at"] > 0
        return True

    assert asyncio.run(run())


def test_queue_requeue_full_counts_as_drop():
    """Regression: the requeue-failure path (a genuine request drop) left
    received > processed + dropped forever."""
    async def run():
        qm = TTSQueueManager(input_queue_size=1)
        qm.register_connection("c")
        assert await qm.enqueue_request(connection_id="c", text="a")
        req = await qm.get_next_request()
        # Fill the queue so the requeue must fail.
        assert await qm.enqueue_request(connection_id="c", text="b")
        assert not await qm.requeue(req)
        m = qm.metrics
        # b is still queued (received, not yet processed); a was dropped.
        assert m["requests_dropped"] == 1
        assert m["requests_received"] == m["requests_processed"] + m["requests_dropped"] + qm.input_queue.qsize()
        return True

    assert asyncio.run(run())


# ---------------------------------------------------------------- embedding cache


def test_voice_cache_lru():
    cache = VoiceEmbeddingCache(max_entries=2)
    cache.put("a", np.zeros(4))
    cache.put("b", np.ones(4))
    assert cache.get("a") is not None
    cache.put("c", np.full(4, 2.0))  # evicts "b" (oldest untouched)
    assert cache.get("b") is None
    assert cache.get("a") is not None
    assert cache.stats["evictions"] == 1


# ---------------------------------------------------------------- dynamic batcher (stub engine)


class StubEngine:
    """Records each device pass; a waveform per text whose length is the token count.
    Sentences are planned as the nova engine plans them."""

    f5 = False
    plan = TTSEngine.plan

    def __init__(self, fail_on=None):
        self.ecfg = EngineConfig(token_buckets=[32, 64, 128], max_batch=8, batch_window_ms=5.0)
        self.tracer = Tracer()
        self.passes = []
        self.fail_on = fail_on

    def synthesize_batch(self, texts, speakers=None, exaggerations=None, pass_id=0, plans=None):
        id_lists = [p.ids for p in plans]
        self.passes.append({"texts": list(texts), "speakers": speakers, "ids": id_lists, "pass_id": pass_id})
        if self.fail_on is not None and any(self.fail_on in t for t in texts):
            raise ValueError("device pass failed")
        return [np.full((len(ids),), i, np.float32) for i, ids in enumerate(id_lists)]


HOUR_MS = 3_600_000.0  # an admission window that only a full batch or stop() ends


async def until(cond, timeout=20.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while not cond():
        assert asyncio.get_event_loop().time() < deadline, "condition not reached"
        await asyncio.sleep(0.005)


def test_dynamic_batcher_coalesces_a_full_window_into_one_pass():
    engine = StubEngine()
    texts = [f"Sentence number {i}." for i in range(4)]
    spk = np.arange(4, dtype=np.float32)

    async def run():
        batcher = DynamicBatcher(engine, max_batch=4, window_ms=HOUR_MS)
        await batcher.start()
        results = await asyncio.gather(*[batcher.submit(t, speaker=spk) for t in texts])
        await batcher.stop()
        return results, batcher.metrics

    results, metrics = asyncio.run(run())
    assert len(engine.passes) == 1 and sorted(engine.passes[0]["texts"]) == texts
    assert all(s is spk for s in engine.passes[0]["speakers"])
    assert engine.passes[0]["ids"] == [list(text_to_ids(t)) for t in engine.passes[0]["texts"]]
    assert metrics["batches"] == 1 and metrics["requests"] == 4 and metrics["max_batch_seen"] == 4
    assert all(isinstance(r, np.ndarray) and r.dtype == np.float32 for r in results)


def test_dynamic_batcher_splits_buckets_into_separate_passes():
    engine = StubEngine()
    long_text = ("many words " * 30).strip() + "."  # > 64 tokens: the 128 bucket

    async def run():
        batcher = DynamicBatcher(engine, max_batch=2, window_ms=HOUR_MS)
        await batcher.start()
        results = await asyncio.gather(batcher.submit("Hi."), batcher.submit(long_text))
        await batcher.stop()
        return results, batcher.metrics

    results, metrics = asyncio.run(run())
    assert metrics["bucket_splits"] == 1 and metrics["batches"] == 2
    assert sorted(len(p["texts"]) for p in engine.passes) == [1, 1]
    assert len(results[0]) == len(text_to_ids("Hi.")) and len(results[1]) == len(text_to_ids(long_text))


def test_dynamic_batcher_stop_flushes_pending():
    engine = StubEngine()

    async def run():
        batcher = DynamicBatcher(engine, max_batch=4, window_ms=HOUR_MS)  # worker not started
        task = asyncio.ensure_future(batcher.submit("Stranded sentence."))
        await until(lambda: not batcher._queue.empty())
        await batcher.stop()
        with pytest.raises(RuntimeError, match="batcher stopped"):
            await asyncio.wait_for(task, timeout=5.0)

    asyncio.run(run())
    assert engine.passes == []


def test_dynamic_batcher_stop_during_admission_window():
    engine = StubEngine()

    async def run():
        batcher = DynamicBatcher(engine, max_batch=4, window_ms=HOUR_MS)
        await batcher.start()
        task = asyncio.ensure_future(batcher.submit("Window sentence."))
        await until(lambda: batcher._queue.empty() and not task.done() and batcher._queue._unfinished_tasks > 0)
        await batcher.stop()
        with pytest.raises(RuntimeError, match="batcher stopped"):
            await asyncio.wait_for(task, timeout=5.0)

    asyncio.run(run())
    assert engine.passes == []  # no device pass after the cancellation


def test_dynamic_batcher_isolates_a_failed_group_and_survives():
    engine = StubEngine(fail_on="many")
    long_text = ("many words " * 30).strip() + "."

    async def run():
        batcher = DynamicBatcher(engine, max_batch=2, window_ms=HOUR_MS)
        await batcher.start()
        ok, bad = await asyncio.gather(batcher.submit("Hi."), batcher.submit(long_text), return_exceptions=True)
        again = await asyncio.gather(batcher.submit("Still alive."), batcher.submit("Me too."))
        await batcher.stop()
        return ok, bad, again

    ok, bad, again = asyncio.run(run())
    assert isinstance(ok, np.ndarray) and isinstance(bad, ValueError)
    assert len(again) == 2 and all(isinstance(r, np.ndarray) for r in again)


def test_dynamic_batcher_worker_survives_assembly_error():
    engine = StubEngine()

    async def run():
        batcher = DynamicBatcher(engine, max_batch=1, window_ms=HOUR_MS)
        await batcher.start()
        # an unhashable bucket: grouping fails outside the per-group guard
        engine.plan = lambda *a: dataclasses.replace(TTSEngine.plan(engine, *a), bucket=[])
        try:
            with pytest.raises(Exception):
                await asyncio.wait_for(batcher.submit("Boom."), 10)
        finally:
            del engine.plan
        out = await asyncio.wait_for(batcher.submit("Still alive."), 10)
        await batcher.stop()
        return out

    assert len(asyncio.run(run())) > 0


# ---------------------------------------------------------------- synthesizer facade


def tiny_config() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1,
        speaker_dim=32, vocos_dim=128, vocos_ff=256, vocos_layers=2,
        compute_dtype="float32",
    )
    cfg.engine = EngineConfig(warmup_shapes=[[1, 32]], stream_chunk_frames=24,
                              stream_context_frames=12)
    return cfg


@pytest.fixture(scope="module")
def synth():
    s = StreamingSynthesizer(tiny_config(), device="cpu")
    asyncio.run(s.load())
    return s


def test_surface_matches_reference(synth):
    # The attribute/method surface callers of the reference class rely on.
    assert synth.is_loaded
    assert synth.sample_rate == 24000
    assert hasattr(synth, "chunk_size")  # accepted-but-unused, like the reference
    stats = synth.get_stats()
    for key in ("syntheses", "total_latency", "first_chunk_latency", "errors",
                "avg_latency", "avg_first_chunk"):
        assert key in stats


def test_not_loaded_raises():
    s = StreamingSynthesizer(tiny_config(), device="cpu")

    async def run():
        async for _ in s.synthesize_streaming("hi"):
            pass

    with pytest.raises(RuntimeError, match="not loaded"):
        asyncio.run(run())


def test_streaming_yields_chunks(synth):
    async def run():
        chunks = []
        async for c in synth.synthesize_streaming("Hello facade. Another sentence."):
            chunks.append(c)
        return chunks

    chunks = asyncio.run(run())
    assert len(chunks) >= 2
    for c in chunks:
        assert isinstance(c, np.ndarray) and c.dtype == np.float32


def test_empty_text_yields_nothing(synth):
    async def run():
        return [c async for c in synth.synthesize_streaming("   ")]

    assert asyncio.run(run()) == []


def test_voice_embedding_accepts_path_and_array(synth, tmp_path):
    rng = np.random.default_rng(0)
    tone = (0.4 * np.sin(2 * np.pi * 220 * np.arange(24000 * 4) / 24000)).astype(np.float32)
    path = str(tmp_path / "v.wav")
    write_wav(path, tone, 24000)

    async def run():
        by_path = [c async for c in synth.synthesize_streaming("Path voice.", voice_embedding=path)]
        emb = await synth.extract_voice_embedding(tone, 24000)
        by_emb = [c async for c in synth.synthesize_streaming("Array voice.", voice_embedding=emb)]
        return by_path, by_emb, emb

    by_path, by_emb, emb = asyncio.run(run())
    assert len(by_path) >= 1 and len(by_emb) >= 1
    assert emb.shape == (32,)
    np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-4)


def test_device_defaults_to_the_configs():
    """Without a `device` argument the facade builds its engine on
    `config.model.device`, as `TTSEngine` does."""
    cfg = tiny_config()
    cfg.model.device = "cpu"
    s = StreamingSynthesizer(cfg)
    assert s.device == torch.device("cpu") and s.engine.device == torch.device("cpu")
    asyncio.run(s.load())
    assert s.is_loaded
    assert next(s.engine.params.parameters()).device == torch.device("cpu")


def test_default_device_without_a_card_raises(monkeypatch):
    """The default `model.device` is "cuda": on a host without a card the facade
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tiny_config().model.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingSynthesizer(tiny_config())


def test_cleanup_unloads(synth):
    s = StreamingSynthesizer(tiny_config(), device="cpu")
    asyncio.run(s.load())
    asyncio.run(s.cleanup())
    assert not s.is_loaded


def test_streaming_early_close_does_not_hang(synth):
    """Regression: aborting the async generator mid-stream used to deadlock — the
    producer thread blocked forever in a cross-thread put on a full queue while
    the generator's finally awaited it."""

    async def run():
        text = " ".join(f"Sentence number {i} here." for i in range(12))
        gen = synth.synthesize_streaming(text)
        first = None
        async for chunk in gen:
            first = chunk
            break  # abandon the stream immediately
        await asyncio.wait_for(gen.aclose(), timeout=10.0)
        return first

    first = asyncio.run(asyncio.wait_for(run(), timeout=30.0))
    assert first is not None and first.dtype == np.float32
