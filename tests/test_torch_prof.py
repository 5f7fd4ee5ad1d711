"""The port's span recorder (`utils/prof.py`) and the spans the service, the batcher
and the engine record, on the CPU.

* The recorder alone: histograms over every sample (beyond the 512 the rolling
  summary it replaced kept), the ring's drop counter, the shared no-op of a
  switched-off tracer (no clock read), and spans under an unrecorded parent.
* One WebSocket session (`register_voice`, then a two-sentence `synthesize`) through
  `TTSService.handle_connection` over `MemorySocket` at a tiny configuration, under
  a CPU torch.profiler that sees every thread, once with `monitoring.trace_spans`
  off and once on: off, no ring entry and no `gonova.*` range; on, parent and
  request ids link the request's spans from `service.request` down to
  `engine.readback`, only synchronous spans open ranges, their clock pairs agree,
  and the Prometheus exposition carries the span histograms.
* The batcher's spans name the pass that served each sentence (a stub engine).
* A pass's span runs on past the device lock: the lock ends before the slicing.
"""

import asyncio
import base64
import gc
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import DynamicBatcher, TTSEngine
from gonova_tts_tpu_torch.service.memory_socket import MemorySocket
from gonova_tts_tpu_torch.service.server import TTSService
from gonova_tts_tpu_torch.utils import Tracer, prof, write_wav

MODEL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    upsample_initial_channel=32, vocos_dim=128, vocos_ff=256, vocos_layers=2,
    compute_dtype="float32", device="cpu",
)
ENGINE = dict(
    token_buckets=[32, 64, 128, 192], batch_buckets=[1, 4], max_batch=4, batch_window_ms=5.0,
    stream_chunk_frames=24, stream_context_frames=8, warmup_shapes=[[1, 32]],
)
TEXT = "Hello there. How are you today?"
SYNC = {"frontend.text_to_ids", "engine.lock_wait", "engine.pass", "engine.encode", "engine.decode_vocode",
        "engine.readback", "engine.unpack", "engine.embed_voice", "engine.embed.resample", "engine.embed.mel",
        "engine.embed.encoder"}
ASYNC = {"service.request", "service.queue_wait", "service.first_audio", "service.register_voice",
         "batcher.wait", "batcher.admission"}


def _profiler():
    try:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        config = None
    return profile(activities=[ProfilerActivity.CPU], experimental_config=config)


def _reference_b64(seconds=4.0, sr=24000):
    t = np.arange(int(seconds * sr)) / sr
    return base64.b64encode(write_wav(None, (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sr)).decode()


def _session(tmp_path, on: bool) -> dict:
    """One connection: register a voice, speak two sentences with it; under a CPU
    torch.profiler from after set-up to the end of the connection."""
    torch.set_num_threads(1)
    cfg = Config()
    cfg.model, cfg.engine = ModelConfig(**MODEL), EngineConfig(**ENGINE)
    cfg.voice_cloning.cache_dir = str(tmp_path / "voices")
    cfg.voice_cloning.default_voice_path = None
    cfg.logging.level = "WARNING"
    cfg.monitoring.trace_spans = on

    async def run():
        svc = TTSService(cfg)
        await svc.start()
        try:
            with _profiler() as p:
                ws = MemorySocket()
                conn = asyncio.create_task(svc.handle_connection(ws, "c1"))
                _, reg = await ws.request({"type": "register_voice", "voice_id": "v1",
                                           "reference_audio": _reference_b64()}, until=("voice_registered", "error"))
                _, frames = await ws.request({"type": "synthesize", "text": TEXT, "voice_id": "v1"},
                                             until=("synthesis_complete", "error"))
                await ws.end()
                await asyncio.wait_for(conn, 60)
            return dict(tracer=svc.tracer, frames=reg + frames, events=list(p.events()),
                        prometheus=svc.metrics_prometheus(), stats=svc.synthesizer.engine.get_stats())
        finally:
            await svc.shutdown()

    return asyncio.run(run())


@pytest.fixture(scope="module")
def off(tmp_path_factory):
    return _session(tmp_path_factory.mktemp("off"), on=False)


@pytest.fixture(scope="module")
def on(tmp_path_factory):
    return _session(tmp_path_factory.mktemp("on"), on=True)


# ---------------------------------------------------------------- the recorder alone


def test_histogram_percentiles_cover_every_sample():
    """600 samples of 1 ms, then 400 of 100 ms: over every sample the median is the
    1 ms one (a summary of the last 512 would read 100 ms)."""
    tracer = Tracer(on=True)
    for ms in [1] * 600 + [100] * 400:
        tracer.record("engine.pass", time.perf_counter_ns() - ms * 1_000_000)
    s = tracer.summary()["engine.pass"]
    assert s["count"] == 1000
    assert 1.0 <= s["p50_ms"] < 1.6
    assert 99.0 <= s["p90_ms"] < 160.0 and 99.0 <= s["p99_ms"] < 160.0
    assert 40.0 < s["mean_ms"] < 41.0


def test_histogram_quantiles_lie_within_one_bucket_of_the_exact_ones():
    durations = np.exp(np.random.default_rng(0).normal(np.log(0.02), 1.0, 5000))
    tracer = Tracer()
    for d in durations:
        tracer._observe("x", int(d * 1e9))
    ratio = 10 ** (1 / 5)
    summary = tracer.summary()["x"]
    for q, key in ((0.5, "p50_ms"), (0.9, "p90_ms"), (0.99, "p99_ms")):
        exact = 1e3 * np.quantile(durations, q)
        assert exact / ratio <= summary[key] <= exact * ratio
    h = tracer.histograms()["x"]
    assert h["buckets"][-1] == h["count"] == 5000 and h["min_s"] == pytest.approx(durations.min(), rel=1e-6)


def test_ring_counts_what_it_drops_once_full():
    tracer = Tracer(on=True, capacity=4)
    for i in range(6):
        tracer.record(f"s{i}", time.perf_counter_ns(), request=("c1", i), pass_id=i)
    assert tracer.dropped == 2
    assert [s.name for s in tracer.spans()] == ["s2", "s3", "s4", "s5"]
    assert sum(h["count"] for h in tracer.histograms().values()) == 6
    assert "gonova_tts_span_ring_dropped 2" in tracer.prometheus()
    for _ in range(3):  # the ring's records leave the collector's watch, a level of tuples a pass
        gc.collect()
    assert not any(gc.is_tracked(r) for r in tracer._ring)


def test_threads_lose_no_span_and_share_no_id():
    """More threads than cores record at once, with a short switch interval: every
    span lands in the ring or the drop count and in its histogram, once."""
    import sys
    import threading

    tracer = Tracer(on=True, capacity=20_000)
    n_threads, each = 16, 1500

    def work():
        for _ in range(each):
            with tracer.span("engine.readback"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * each
    spans = tracer.spans()
    assert len(spans) + tracer.dropped == total and tracer.dropped == total - 20_000
    assert len({s.id for s in spans}) == len(spans)
    assert tracer.histograms()["engine.readback"]["count"] == total


def test_switched_off_spans_read_no_clock(monkeypatch):
    tracer = Tracer()
    calls = []
    real = time.perf_counter_ns
    monkeypatch.setattr(prof.time, "perf_counter_ns", lambda: calls.append(1) or real())
    assert tracer.span("frontend.text_to_ids") is prof.NOOP and tracer.begin("service.request") is prof.NOOP
    with tracer.span("engine.readback", batch=4) as sp:
        sp.set(frame_bucket=128)
    tracer.record("batcher.wait", 0)
    tracer.finish(tracer.begin("service.request"))
    assert calls == [] and tracer.spans() == [] and tracer.histograms() == {}
    with tracer.span("engine.pass"):  # one of the spans timed before spans existed
        pass
    assert len(calls) == 2 and tracer.spans() == [] and tracer.summary()["engine.pass"]["count"] == 1


def test_a_span_under_an_unrecorded_parent_is_not_recorded():
    """Switched on while a request was in flight: its children are not recorded as
    roots, and the engine's histograms still count."""
    tracer = Tracer(on=True)
    with tracer.within(prof.NOOP):
        assert tracer.begin("batcher.wait") is prof.NOOP
        with tracer.span("frontend.text_to_ids") as sp:
            assert sp is prof.NOOP
        with tracer.span("engine.pass"):
            pass
    tracer.record("service.first_audio", time.perf_counter_ns(), parent=prof.NOOP)
    assert tracer.spans() == [] and set(tracer.histograms()) == {"engine.pass"}


# ---------------------------------------------------------------- one WebSocket session


def test_switched_off_service_keeps_no_ring_and_opens_no_range(off):
    assert [k for _, k, _ in off["frames"]].count("binary") >= 1
    assert off["tracer"].spans() == [] and off["tracer"].dropped == 0
    assert not [e.name for e in off["events"] if e.name.startswith("gonova.")]
    assert set(off["stats"]["timers"]) == {"engine.pass", "engine.embed_voice"}


def test_switched_on_ids_link_one_request_from_the_service_to_the_readbacks(on):
    spans = on["tracer"].spans()
    by_id = {s.id: s for s in spans}
    (req,) = [s for s in spans if s.name == "service.request"]
    assert req.request == ("c1", 0) and req.parent == 0
    under = [s for s in spans if s.parent == req.id]
    names = sorted(s.name for s in under)
    assert names.count("frontend.text_to_ids") == 2 and names.count("batcher.wait") == 2
    assert {"service.queue_wait", "service.first_audio", "engine.embed_voice"} <= set(names)
    assert all(s.request == ("c1", 0) for s in under)
    (embed,) = [s for s in under if s.name == "engine.embed_voice"]
    assert sorted(s.name for s in spans if s.parent == embed.id) == [
        "engine.embed.encoder", "engine.embed.mel", "engine.embed.resample", "engine.readback"]
    passes = {s.attrs["pass_id"] for s in under if s.name == "batcher.wait"}
    assert len(passes) == 1
    p = by_id[passes.pop()]
    assert p.name == "engine.pass" and p.attrs["batch"] == 2
    assert {"batch", "batch_bucket", "token_bucket", "frame_bucket", "real_tokens"} <= set(p.attrs)
    assert by_id[p.parent].name == "batcher.admission" and by_id[p.parent].attrs == {"items": 2, "groups": 1}
    children = sorted(s.name for s in spans if s.parent == p.id)
    assert children == ["engine.decode_vocode", "engine.encode", "engine.readback", "engine.readback",
                        "engine.unpack"]  # two-stage: the frame counts' and the audio's readbacks
    first = next(s for s in under if s.name == "service.first_audio")
    assert first.start == req.start and first.end >= p.end
    (reg,) = [s for s in spans if s.name == "service.register_voice"]
    assert reg.request == ("c1", None)
    assert on["tracer"].dropped == 0


def test_only_synchronous_spans_open_profiler_ranges(on):
    ranged = {e.name[len("gonova."):] for e in on["events"] if e.name.startswith("gonova.")}
    assert ranged == SYNC
    spans = on["tracer"].spans()
    assert all(s.rf is None for s in spans if s.name in ASYNC)
    assert all(s.rf is not None for s in spans if s.name in SYNC)


def test_clock_pairs_agree_under_a_cpu_profiler(on):
    """Each span that opened a range, at the middle of the call that opened it,
    against its `gonova.<name>` event (both in start order per name): one offset
    puts every pair within 100 us. A pair counts where that call returned within
    200 us of the span's start (a thread switch inside the call widens the
    bracket the range's start lies in)."""
    events = {}
    for e in sorted(on["events"], key=lambda e: e.time_range.start):
        if e.name.startswith("gonova."):
            events.setdefault(e.name[len("gonova."):], []).append(e.time_range.start)
    diffs = []
    for name, starts in events.items():
        mine = sorted((s.start, s.rf) for s in on["tracer"].spans() if s.name == name)
        assert len(mine) == len(starts), name
        diffs += [theirs - (own + rf / 2) / 1e3 for (own, rf), theirs in zip(mine, starts) if rf <= 200_000]
    offset = float(np.median(diffs))
    assert len(diffs) >= 5
    assert max(abs(d - offset) for d in diffs) <= 100.0


def test_prometheus_exposition_carries_the_span_histograms(on):
    text = on["prometheus"]
    assert "# TYPE gonova_tts_span_seconds histogram" in text
    assert 'gonova_tts_span_seconds_bucket{span="engine.pass",le="+Inf"} 1' in text
    assert 'gonova_tts_span_seconds_count{span="service.first_audio"} 1' in text
    assert 'gonova_tts_span_seconds_sum{span="batcher.wait"}' in text
    for key in ("padded_tokens", "real_tokens", "vocode_frames_executed", "truncated_sentences"):
        assert f"# TYPE gonova_tts_engine_{key} counter" in text
    assert "# TYPE gonova_tts_batcher_batches counter" in text
    counts = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
              if line.startswith('gonova_tts_span_seconds_bucket{span="frontend.text_to_ids"')]
    assert counts == sorted(counts) and counts[-1] == 2  # cumulative


# ---------------------------------------------------------------- the batcher


class _PassEngine:
    f5 = False
    plan = TTSEngine.plan

    def __init__(self):
        self.ecfg = EngineConfig(token_buckets=[32, 64, 128], max_batch=8, batch_window_ms=5.0)
        self.tracer = Tracer(on=True)

    def synthesize_batch(self, texts, speakers=None, exaggerations=None, pass_id=0, plans=None):
        with self.tracer.span("engine.pass", id=pass_id, batch=len(texts)):
            return [np.zeros(len(p.ids), np.float32) for p in plans]


def test_batcher_waits_name_their_pass_and_bucket():
    engine = _PassEngine()
    long_text = ("many words " * 30).strip() + "."  # the 128 bucket

    async def run():
        batcher = DynamicBatcher(engine, max_batch=3, window_ms=3_600_000.0)
        await batcher.start()
        t0 = time.perf_counter_ns()
        await asyncio.gather(batcher.submit("Hi."), batcher.submit("Hello there."), batcher.submit(long_text))
        await batcher.stop()
        return t0

    t0 = asyncio.run(run())
    spans = engine.tracer.spans()
    passes = {s.id: s for s in spans if s.name == "engine.pass"}
    waits = [s for s in spans if s.name == "batcher.wait"]
    (adm,) = [s for s in spans if s.name == "batcher.admission"]
    assert adm.attrs == {"items": 3, "groups": 2} and len(passes) == 2 and len(waits) == 3
    assert all(p.parent == adm.id for p in passes.values())
    served = {}
    for w in waits:
        served.setdefault(w.attrs["pass_id"], []).append(w.attrs["token_bucket"])
        assert t0 <= w.start <= w.end <= passes[w.attrs["pass_id"]].start
    assert sorted(served.values()) == [[32, 32], [128]]
    assert sorted(p.attrs["batch"] for p in passes.values()) == [1, 2]
    assert len([s for s in spans if s.name == "frontend.text_to_ids"]) == 3


# ---------------------------------------------------------------- the device lock


class _HeldLock:
    """The engine's lock, noting when it is released."""

    def __init__(self):
        import threading

        self._lock, self.released = threading.Lock(), []

    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        self.released.append(time.perf_counter_ns())
        self._lock.release()


def test_the_device_lock_ends_before_the_results_are_sliced():
    """The lock covers the readbacks and their f32 conversion; `engine.pass` and
    its `engine.unpack` close after the per-row slicing, with the lock released."""
    from gonova_tts_tpu_torch.engine import TTSEngine

    torch.set_num_threads(1)
    cfg = Config()
    cfg.model, cfg.engine = ModelConfig(**MODEL), EngineConfig(**ENGINE)
    cfg.monitoring.trace_spans = True
    engine = TTSEngine(cfg, device="cpu", seed=0)
    engine.load(warmup=False)
    engine._lock = lock = _HeldLock()
    outs = engine.synthesize_batch(["Hello there.", "How are you today?"], pass_id=77)
    assert len(outs) == 2 and all(o.dtype == np.float32 and o.flags.owndata for o in outs)
    spans = engine.tracer.spans()
    (p,) = [s for s in spans if s.name == "engine.pass"]
    (released,) = lock.released
    assert p.id == 77 and p.attrs["batch"] == 2
    children = {s.name: s for s in spans if s.parent == p.id}
    unpack = children["engine.unpack"]
    assert all(s.end <= released for s in spans if s.parent == p.id and s.name != "engine.unpack")
    assert p.start < unpack.start < released < unpack.end <= p.end
    assert engine._lock.acquire(blocking=False)
