"""The port's WS/REST service on the CPU, against the JAX package's.

* The protocol cases of tests/test_service_ws.py, run against the port's app
  (`gonova_tts_tpu_torch.service.server.create_app`) through aiohttp's TestClient, at
  the same tiny configuration with `model.device="cpu"`.
* A golden transcript: one scripted WS session against the JAX app and the port's app,
  both serving one seeded checkpoint (written by the JAX package's `save_params_npz`,
  read by both through `model.model_path`). Same message types and JSON bodies, same
  binary frame counts, float32 audio within 1.01/32767 (the engines' bound in
  tests/test_torch_engine.py), byte-equal wav headers, and mp3/opus frames that are
  the JAX encoder's frames of the app's own PCM.
* Without aiohttp (a subprocess with `sys.modules["aiohttp"] = None`): the service
  imports and serves one `synthesize` through an in-memory socket; `create_app`
  raises an ImportError naming aiohttp.
"""

import asyncio
import base64
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from aiohttp import WSMsgType as AioWSMsgType
from aiohttp.test_utils import TestClient, TestServer

from gonova_tts_tpu.audio import encode as jenc
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import DynamicBatcher
from gonova_tts_tpu_torch.service import server as srv
from gonova_tts_tpu_torch.utils import read_wav, write_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOICE_WAV = ROOT / "assets" / "default_voice.wav"
LSB16 = 1.0 / 32767.0
MODEL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    upsample_initial_channel=32, vocos_dim=128, vocos_ff=256, vocos_layers=2,
    compute_dtype="float32",
)
ENGINE = dict(
    token_buckets=[32, 64, 128, 192], batch_buckets=[1, 4], max_batch=4,
    batch_window_ms=5.0, stream_chunk_frames=24, stream_context_frames=8,
    warmup_shapes=[[1, 32]],
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores."""
    torch.set_num_threads(1)


def fill(cfg, tmp_path, model_cls, engine_cls, **model):
    cfg.model = model_cls(**MODEL, **model)
    cfg.engine = engine_cls(**ENGINE)
    cfg.voice_cloning.cache_dir = str(tmp_path / "voices")
    cfg.voice_cloning.default_voice_path = None
    cfg.logging.level = "WARNING"
    return cfg


def service_config(tmp_path, **model) -> Config:
    return fill(Config(), tmp_path, ModelConfig, EngineConfig, device="cpu", **model)


def _tone_wav_b64(secs=5.0, sr=24000):
    rng = np.random.default_rng(0)
    t = np.arange(int(secs * sr)) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(len(t))).astype(
        np.float32
    )
    return base64.b64encode(write_wav(None, audio, sr)).decode()


async def _collect_synthesis(ws):
    """Read frames until synthesis_complete; return (audio_chunks, final_msg)."""
    chunks = []
    while True:
        msg = await asyncio.wait_for(ws.receive(), timeout=120)
        if msg.type == srv.WSMsgType.BINARY:
            chunks.append(np.frombuffer(msg.data, dtype=np.float32))
        elif msg.type == srv.WSMsgType.TEXT:
            data = json.loads(msg.data)
            if data.get("type") == "synthesis_complete":
                return chunks, data
        else:
            raise AssertionError(f"unexpected WS message: {msg.type}")


@pytest.fixture(scope="module")
def client_ctx(tmp_path_factory):
    """One loaded port service/app shared by the protocol cases; each test opens its
    own connections."""
    tmp_path = tmp_path_factory.mktemp("svc")
    loop = asyncio.new_event_loop()
    app = srv.create_app(service_config(tmp_path))
    client = TestClient(TestServer(app), loop=loop)
    loop.run_until_complete(client.start_server())
    yield loop, client, client.server.app["service"]
    loop.run_until_complete(client.close())
    loop.close()


def test_ws_msg_type_values_are_aiohttps():
    assert {m.name: int(m) for m in srv.WSMsgType} == {m.name: int(m) for m in AioWSMsgType}
    for m in AioWSMsgType:
        assert m == srv.WSMsgType[m.name]


@pytest.mark.parametrize("case", ["loaded", "device_health"])
def test_health(client_ctx, case):
    loop, client, svc = client_ctx

    async def run():
        resp = await client.get("/health")
        assert resp.status == 200
        return await resp.json()

    body = loop.run_until_complete(run())
    assert body["status"] == "healthy"
    if case == "loaded":
        assert "queue_metrics" in body and "synthesizer_stats" in body
        assert "voice_stats" in body and "tpu" in body
        assert body["tpu"] == {"backend": "cpu", "device_count": 1, "devices": ["cpu"]}
        assert body["device"] == "cpu"
        status, plain = svc.health()
        assert status == 200 and set(plain) == set(body) and plain["tpu"] == body["tpu"]
    else:
        assert "device_health" in body


def test_metrics_endpoint(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        resp = await client.get("/metrics")
        assert resp.status == 200
        body = await resp.json()
        assert "requests_received" in body and "chunks_sent" in body
        assert set(body) == set(svc.metrics())
        return True

    assert loop.run_until_complete(run())


def test_metrics_prometheus_format(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        resp = await client.get("/metrics", params={"format": "prometheus"})
        assert resp.status == 200
        text = await resp.text()
        assert "# TYPE gonova_tts_requests_received counter" in text
        assert "gonova_tts_active_connections" in text
        assert "# TYPE gonova_tts_batcher_batches counter" in text
        return True

    assert loop.run_until_complete(run())


def test_ws_synthesize_binary_then_complete(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        ws = await client.ws_connect("/v1/stream/tts")
        await ws.send_json({"type": "synthesize", "text": "Hello world. Second sentence."})
        chunks, final = await _collect_synthesis(ws)
        await ws.close()
        assert len(chunks) == 2  # one binary frame per sentence
        assert final["chunk_id"] == 2
        for c in chunks:
            assert c.dtype == np.float32 and len(c) > 0
            assert np.isfinite(c).all()
        return True

    assert loop.run_until_complete(run())


def test_ws_synthesize_encoded_formats(client_ctx):
    """mp3/opus binary frames carry the encoded stream; an unknown format errors at
    admission, and the connection stays usable."""
    loop, client, svc = client_ctx

    async def collect_bytes(ws):
        blobs, final = [], None
        while final is None:
            msg = await asyncio.wait_for(ws.receive(), timeout=120)
            if msg.type == srv.WSMsgType.BINARY:
                blobs.append(msg.data)
            elif msg.type == srv.WSMsgType.TEXT:
                data = json.loads(msg.data)
                if data.get("type") in ("synthesis_complete", "error"):
                    final = data
        return b"".join(blobs), final

    async def run():
        ws = await client.ws_connect("/v1/stream/tts")
        if "mp3" in jenc.available_formats():
            await ws.send_json(
                {"type": "synthesize", "text": "Encoded one. Encoded two.", "format": "mp3"}
            )
            blob, final = await collect_bytes(ws)
            assert final["type"] == "synthesis_complete"
            assert blob[0] == 0xFF and (blob[1] & 0xE0) == 0xE0  # MPEG sync
        if "opus" in jenc.available_formats():
            await ws.send_json({"type": "synthesize", "text": "Opus check.", "format": "opus"})
            blob, final = await collect_bytes(ws)
            assert final["type"] == "synthesis_complete"
            assert blob[:4] == b"OggS" and b"OpusHead" in blob[:64]
        await ws.send_json({"type": "synthesize", "text": "Nope.", "format": "flac"})
        msg = json.loads((await asyncio.wait_for(ws.receive(), timeout=30)).data)
        assert msg["type"] == "error" and "Unsupported format" in msg["message"]
        await ws.send_json({"type": "synthesize", "text": "Still alive."})
        chunks, final = await _collect_synthesis(ws)
        assert len(chunks) == 1 and final["chunk_id"] == 1
        await ws.close()
        return True

    assert loop.run_until_complete(run())


def test_rest_synthesize_mp3_opus(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        if "mp3" in jenc.available_formats():
            resp = await client.post("/v1/synthesize", json={"text": "Rest MP3.", "format": "mp3"})
            assert resp.status == 200 and resp.content_type == "audio/mpeg"
            body = await resp.read()
            assert body[0] == 0xFF and (body[1] & 0xE0) == 0xE0
        if "opus" in jenc.available_formats():
            resp = await client.post("/v1/synthesize", json={"text": "Rest Opus.", "format": "opus"})
            assert resp.status == 200 and resp.content_type == "audio/ogg"
            body = await resp.read()
            assert body[:4] == b"OggS"
        resp = await client.post("/v1/synthesize", json={"text": "Bad.", "format": "flac"})
        assert resp.status == 400
        assert "supported" in await resp.json()
        return True

    assert loop.run_until_complete(run())


def test_format_admission_is_sample_rate_aware(client_ctx):
    """At a model rate opus cannot encode (22050 Hz), admission rejects before any
    synthesis: REST 400, WS admission error."""
    loop, client, svc = client_ctx
    orig_sr = svc.config.model.sample_rate

    async def run():
        svc.config.model.sample_rate = 22050
        try:
            resp = await client.post("/v1/synthesize", json={"text": "Rate gated.", "format": "opus"})
            assert resp.status == 400
            body = await resp.json()
            assert "opus" not in body["supported"]

            ws = await client.ws_connect("/v1/stream/tts")
            await ws.send_json({"type": "synthesize", "text": "Rate gated.", "format": "opus"})
            msg = json.loads((await asyncio.wait_for(ws.receive(), timeout=30)).data)
            assert msg["type"] == "error" and "Unsupported format" in msg["message"]
            await ws.close()
        finally:
            svc.config.model.sample_rate = orig_sr
        return True

    assert loop.run_until_complete(run())


def test_ws_register_then_synthesize_with_voice(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        ws = await client.ws_connect("/v1/stream/tts")
        await ws.send_json({
            "type": "register_voice", "voice_id": "tester",
            "reference_audio": _tone_wav_b64(), "description": "unit voice",
        })
        msg = json.loads((await asyncio.wait_for(ws.receive(), 120)).data)
        assert msg == {"type": "voice_registered", "voice_id": "tester"}

        await ws.send_json({"type": "list_voices"})
        msg = json.loads((await asyncio.wait_for(ws.receive(), 30)).data)
        assert msg["type"] == "voice_list"
        assert any(v["voice_id"] == "tester" for v in msg["voices"])

        await ws.send_json({"type": "synthesize", "text": "Voice test.", "voice_id": "tester"})
        chunks, final = await _collect_synthesis(ws)
        assert len(chunks) == 1 and final["chunk_id"] == 1
        await ws.close()
        return True

    assert loop.run_until_complete(run())
    assert svc.voice_embeddings.get("tester") is not None  # cached under the sanitized id


@pytest.mark.parametrize(
    "message, expect",
    [
        ({"voice_id": "bad", "reference_audio": base64.b64encode(b"not a wav").decode()}, "failed"),
        ({"voice_id": "nobody"}, "required"),
    ],
    ids=["invalid_audio", "missing_fields"],
)
def test_ws_register_voice_errors_answer(client_ctx, message, expect):
    """A registration that cannot succeed answers with an error frame instead of
    leaving the client awaiting voice_registered."""
    loop, client, svc = client_ctx

    async def run():
        ws = await client.ws_connect("/v1/stream/tts")
        await ws.send_json({"type": "register_voice", **message})
        msg = json.loads((await asyncio.wait_for(ws.receive(), 30)).data)
        await ws.close()
        return msg

    msg = loop.run_until_complete(run())
    assert msg["type"] == "error" and expect in msg["message"].lower()


@pytest.mark.parametrize("first", [{"voice_id": "no-such-voice"}, None], ids=["unknown_voice", "unknown_type"])
def test_ws_unknown_input_still_synthesizes(client_ctx, first):
    """An unknown voice_id falls back to the default voice with no error frame; an
    unknown message type is ignored and the connection stays usable."""
    loop, client, svc = client_ctx

    async def run():
        ws = await client.ws_connect("/v1/stream/tts")
        if first is None:
            await ws.send_json({"type": "bogus"})
            await ws.send_json({"type": "synthesize", "text": "Still alive."})
        else:
            await ws.send_json({"type": "synthesize", "text": "Fallback check.", **first})
        chunks, final = await _collect_synthesis(ws)
        await ws.close()
        return chunks, final

    chunks, final = loop.run_until_complete(run())
    assert len(chunks) == 1 and final == {"type": "synthesis_complete", "chunk_id": 1}


def test_ws_cancel(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        ws = await client.ws_connect("/v1/stream/tts")
        await ws.send_json({"type": "cancel"})
        msg = json.loads((await asyncio.wait_for(ws.receive(), 30)).data)
        assert msg == {"type": "cancelled"}
        await ws.send_json({"type": "synthesize", "text": "After cancel."})
        chunks, _ = await _collect_synthesis(ws)
        assert len(chunks) == 1
        await ws.close()
        return True

    assert loop.run_until_complete(run())


def test_rest_synthesize_returns_wav(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        resp = await client.post(
            "/v1/synthesize", json={"text": "Rest endpoint test. Two sentences here.", "format": "wav"}
        )
        assert resp.status == 200
        assert resp.content_type == "audio/wav"
        audio, sr = read_wav(await resp.read())
        assert sr == 24000
        assert len(audio) > 0 and np.isfinite(audio).all()
        return True

    assert loop.run_until_complete(run())


def test_rest_default_format_honors_config(client_ctx):
    """A REST request without `format` uses encoding.default_format, the knob the WS
    path honors."""
    loop, client, svc = client_ctx

    async def run():
        assert svc.config.encoding.default_format == "pcm"
        resp = await client.post("/v1/synthesize", json={"text": "Default format."})
        assert resp.status == 200
        assert resp.content_type == "application/octet-stream"
        audio = np.frombuffer(await resp.read(), dtype=np.float32)
        assert len(audio) > 0 and np.isfinite(audio).all()

        svc.config.encoding.default_format = "wav"
        try:
            resp = await client.post("/v1/synthesize", json={"text": "Now wav."})
            assert resp.status == 200
            assert resp.content_type == "audio/wav"
        finally:
            svc.config.encoding.default_format = "pcm"
        return True

    assert loop.run_until_complete(run())


def test_rest_synthesize_pcm_and_errors(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        resp = await client.post("/v1/synthesize", json={"text": "PCM.", "format": "pcm"})
        assert resp.status == 200
        assert resp.headers["X-Sample-Rate"] == "24000"
        audio = np.frombuffer(await resp.read(), dtype=np.float32)
        assert len(audio) > 0

        resp = await client.post("/v1/synthesize", json={"text": "   "})
        assert resp.status == 400
        resp = await client.post("/v1/synthesize", data=b"not json")
        assert resp.status == 400
        return True

    assert loop.run_until_complete(run())


def test_concurrent_connections_batched(client_ctx):
    """Four simultaneous WS requests all complete, and the batcher coalesces them into
    one device pass. Its window is one that only a full batch ends, so the count does
    not depend on timing."""
    loop, client, svc = client_ctx
    batcher = DynamicBatcher(svc.synthesizer.engine, max_batch=4, window_ms=600_000.0)
    old = svc.batcher

    async def one(i):
        ws = await client.ws_connect("/v1/stream/tts")
        await ws.send_json({"type": "synthesize", "text": f"Concurrent request {i}."})
        chunks, final = await _collect_synthesis(ws)
        await ws.close()
        return len(chunks)

    async def run():
        await batcher.start()
        svc.batcher = batcher
        try:
            return await asyncio.wait_for(asyncio.gather(*[one(i) for i in range(4)]), 120)
        finally:
            svc.batcher = old
            await batcher.stop()

    assert loop.run_until_complete(run()) == [1, 1, 1, 1]
    assert batcher.metrics == {"batches": 1, "requests": 4, "max_batch_seen": 4, "bucket_splits": 0}


@pytest.mark.parametrize("limit", ["rate_limit", "max_connections"])
def test_admission_rejects_with_1008(client_ctx, limit):
    loop, client, svc = client_ctx

    async def run():
        if limit == "rate_limit":
            for _ in range(svc.rate_limiter.max_requests + 1):
                svc.rate_limiter.check("127.0.0.1")
        else:
            svc.max_connections = 0
        try:
            ws = await client.ws_connect("/v1/stream/tts")
            msg = await asyncio.wait_for(ws.receive(), 30)
            await ws.close()
        finally:
            svc.rate_limiter._requests.clear()
            svc.max_connections = 50
        return msg

    msg = loop.run_until_complete(run())
    assert msg.type == srv.WSMsgType.CLOSE and msg.data == srv.WS_POLICY_VIOLATION


def test_metadata_optin_synthesis_started(client_ctx):
    """With "metadata": true, a synthesis_started frame precedes audio; absent by
    default."""
    loop, client, svc = client_ctx

    async def run():
        ws = await client.ws_connect("/v1/stream/tts")
        await ws.send_json({"type": "synthesize", "text": "Announce me.", "metadata": True})
        first = json.loads((await asyncio.wait_for(ws.receive(), 120)).data)
        assert first == {"type": "synthesis_started"}
        chunks, final = await _collect_synthesis(ws)
        assert len(chunks) == 1
        await ws.send_json({"type": "synthesize", "text": "Silent start."})
        msg = await asyncio.wait_for(ws.receive(), 120)
        assert msg.type == srv.WSMsgType.BINARY
        await _collect_synthesis(ws)
        await ws.close()
        return True

    assert loop.run_until_complete(run())


def test_malformed_json_gets_error_frame(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        ws = await client.ws_connect("/v1/stream/tts")
        await ws.send_str("{not json")
        msg = json.loads((await asyncio.wait_for(ws.receive(), 30)).data)
        assert msg["type"] == "error"
        await ws.send_json({"type": "list_voices"})
        msg2 = json.loads((await asyncio.wait_for(ws.receive(), 30)).data)
        assert msg2["type"] == "voice_list"
        await ws.close()
        return True

    assert loop.run_until_complete(run())


def test_rest_rejected_during_drain(client_ctx):
    loop, client, svc = client_ctx

    async def run():
        svc.is_draining = True
        try:
            resp = await client.post("/v1/synthesize", json={"text": "Nope."})
            assert resp.status == 503
        finally:
            svc.is_draining = False
        return True

    assert loop.run_until_complete(run())


# ---------------------------------------------------------------- golden transcript


GOLDEN_TEXT = "The golden session speaks. It has two sentences."


async def _session(client, payload, formats):
    """One scripted WS session; returns [(request, [(kind, body), ...]), ...] where a
    JSON body is a dict and a binary body is bytes."""
    ws = await client.ws_connect("/v1/stream/tts")
    steps = [
        ({"type": "register_voice", "voice_id": "golden", "reference_audio": payload}, "voice_registered"),
        ({"type": "synthesize", "text": GOLDEN_TEXT, "voice_id": "golden"}, "synthesis_complete"),
        ({"type": "synthesize", "text": GOLDEN_TEXT}, "synthesis_complete"),
        ({"type": "list_voices"}, "voice_list"),
        ({"type": "bogus"}, None),
        ({"type": "synthesize", "text": "One sentence in pcm."}, "synthesis_complete"),
    ]
    steps += [
        ({"type": "synthesize", "text": "One sentence in pcm.", "format": fmt}, "synthesis_complete")
        for fmt in formats
    ]
    transcript = []
    for request, last in steps:
        await ws.send_json(request)
        frames = []
        while last is not None:
            msg = await asyncio.wait_for(ws.receive(), 120)
            if msg.type == srv.WSMsgType.BINARY:
                frames.append(("binary", msg.data))
            else:
                assert msg.type == srv.WSMsgType.TEXT, msg.type
                body = json.loads(msg.data)
                frames.append(("json", body))
                if body["type"] == last:
                    break
        transcript.append((request, frames))
    await ws.close()
    return transcript


def _comparable(body: dict) -> dict:
    """A JSON body without what differs between two deployments: the voice files'
    directory."""
    if body.get("type") == "voice_list":
        return {**body, "voices": [{**v, "path": os.path.basename(v["path"])} for v in body["voices"]]}
    return body


def _frames_of(mod, fmt, pcm_frames):
    """What `mod`'s stream encoder makes of these PCM frames, frame by frame, as the
    service sends them."""
    e = mod.make_encoder(fmt, 24000)
    frames = [e.encode(np.frombuffer(f, np.float32)) for f in pcm_frames]
    return [f for f in frames + [e.flush()] if f]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Both apps on one seeded checkpoint; each with a configured default voice that
    does not exist, so both fall back to the shipped assets/default_voice.wav."""
    import jax

    from gonova_tts_tpu.config import Config as JConfig
    from gonova_tts_tpu.config import EngineConfig as JEngineConfig
    from gonova_tts_tpu.config import ModelConfig as JModelConfig
    from gonova_tts_tpu.models import tts as jtts
    from gonova_tts_tpu.service import server as jsrv
    from gonova_tts_tpu.train.checkpoint import save_params_npz

    tmp = tmp_path_factory.mktemp("golden")
    ckpt = save_params_npz(
        str(tmp / "tiny.npz"), jtts.init(jax.random.PRNGKey(0), JModelConfig(**MODEL)), dtype="float32"
    )
    jcfg = fill(JConfig(), tmp / "jax", JModelConfig, JEngineConfig, model_path=ckpt)
    pcfg = service_config(tmp / "port", model_path=ckpt)
    for cfg in (jcfg, pcfg):
        cfg.voice_cloning.default_voice_path = str(tmp / "missing.wav")
    payload = base64.b64encode(VOICE_WAV.read_bytes()).decode()
    formats = [f for f in ("wav", "mp3", "opus") if f in jenc.available_formats(24000)]

    loop = asyncio.new_event_loop()
    clients = [TestClient(TestServer(jsrv.create_app(jcfg)), loop=loop),
               TestClient(TestServer(srv.create_app(pcfg)), loop=loop)]
    try:
        for c in clients:
            loop.run_until_complete(c.start_server())
        services = [c.server.app["service"] for c in clients]
        transcripts = [loop.run_until_complete(_session(c, payload, formats)) for c in clients]
    finally:
        for c in clients:
            loop.run_until_complete(c.close())
        loop.close()
    return transcripts, services, formats


def test_golden_transcript_messages_and_frame_counts(golden):
    (theirs, ours), _, formats = golden
    assert "wav" in formats
    assert [r for r, _ in ours] == [r for r, _ in theirs]
    for (request, a), (_, b) in zip(ours, theirs):
        assert [k for k, _ in a] == [k for k, _ in b], request
        assert [_comparable(x) for k, x in a if k == "json"] == [_comparable(x) for k, x in b if k == "json"]
    kinds = [[k for k, _ in frames] for _, frames in ours]
    assert kinds[0] == ["json"] and ours[0][1][0][1] == {"type": "voice_registered", "voice_id": "golden"}
    assert kinds[1] == kinds[2] == ["binary", "binary", "json"]  # one frame per sentence
    assert kinds[4] == []  # the unknown message type is not answered
    voices = ours[3][1][0][1]["voices"]
    assert [v["voice_id"] for v in voices] == ["golden"]


def test_golden_transcript_audio_within_one_lsb(golden):
    (theirs, ours), _, _ = golden
    n = 0
    for (request, a), (_, b) in zip(ours, theirs):
        if request.get("type") != "synthesize" or request.get("format", "pcm") != "pcm":
            continue
        for (ka, xa), (_, xb) in zip(a, b):
            if ka == "binary":
                fa, fb = np.frombuffer(xa, np.float32), np.frombuffer(xb, np.float32)
                assert fa.shape == fb.shape and fa.size > 0 and np.isfinite(fa).all()
                np.testing.assert_allclose(fa, fb, atol=1.01 * LSB16, rtol=0)
                n += 1
    assert n == 5
    # The cloned voice and the default voice give different audio.
    cloned, default = ours[1][1][0][1], ours[2][1][0][1]
    assert cloned != default


def test_golden_transcript_encoded_framing(golden):
    """wav headers byte-equal, wav PCM within one int16 step; every encoded frame is
    the JAX encoder's frame of the same app's own PCM for that text."""
    (theirs, ours), _, formats = golden
    for transcript in (ours, theirs):
        pcm = [x for k, x in transcript[5][1] if k == "binary"]
        for i, fmt in enumerate(formats):
            request, frames = transcript[6 + i]
            assert request["format"] == fmt
            assert [x for k, x in frames if k == "binary"] == _frames_of(jenc, fmt, pcm), fmt
    wav_ours = b"".join(x for k, x in ours[6][1] if k == "binary")
    wav_theirs = b"".join(x for k, x in theirs[6][1] if k == "binary")
    assert wav_ours[:44] == wav_theirs[:44] and wav_ours[:4] == b"RIFF"
    a, b = np.frombuffer(wav_ours[44:], np.int16), np.frombuffer(wav_theirs[44:], np.int16)
    assert a.shape == b.shape and int(np.abs(a.astype(np.int32) - b).max()) <= 1


def test_golden_default_voice_falls_back_to_the_shipped_asset(golden):
    """A configured default voice that is missing falls back to assets/default_voice.wav,
    found from the module's depth in the package, in both services alike."""
    _, (jsvc, psvc), _ = golden
    assert psvc._default_speaker is not None and jsvc._default_speaker is not None
    np.testing.assert_allclose(psvc._default_speaker, np.asarray(jsvc._default_speaker), atol=1e-4)
    assert psvc.is_shutting_down and psvc.active_connections == 0  # drained by the app's shutdown


# ---------------------------------------------------------------- without aiohttp


NO_AIOHTTP = r"""
import asyncio, json, sys, tempfile
sys.modules["aiohttp"] = None
import torch
torch.set_num_threads(1)
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.service import TTSService
from gonova_tts_tpu_torch.service import server

class Msg:
    def __init__(self, type, data):
        self.type, self.data = type, data

class MemorySocket:
    def __init__(self):
        self.inbound, self.sent = asyncio.Queue(), []
        self.done = asyncio.Event()
    def __aiter__(self):
        return self
    async def __anext__(self):
        msg = await self.inbound.get()
        if msg is None:
            raise StopAsyncIteration
        return msg
    async def send_json(self, data):
        self.sent.append(data)
        if data.get("type") == "synthesis_complete":
            self.done.set()
    async def send_bytes(self, data):
        self.sent.append(len(data))
    async def close(self, **kw):
        pass

async def main(cache):
    cfg = Config()
    cfg.model = ModelConfig(**json.loads(sys.argv[1]), device="cpu")
    cfg.engine = EngineConfig(**json.loads(sys.argv[2]))
    cfg.voice_cloning.cache_dir, cfg.voice_cloning.default_voice_path = cache, None
    cfg.logging.level = "WARNING"
    svc = TTSService(cfg)
    await svc.start()
    ws = MemorySocket()
    conn = asyncio.create_task(svc.handle_connection(ws, "c0"))
    await ws.inbound.put(Msg(1, json.dumps({"type": "synthesize", "text": "No aiohttp. Two frames."})))
    await asyncio.wait_for(ws.done.wait(), 120)
    await ws.inbound.put(None)
    await conn
    await svc.shutdown()
    try:
        server.create_app(cfg)
        error = None
    except ImportError as e:
        error = str(e)
    print(json.dumps({"sent": ws.sent, "aiohttp_loaded": sys.modules["aiohttp"] is not None,
                      "create_app_error": error, "active": svc.active_connections}))

with tempfile.TemporaryDirectory() as d:
    asyncio.run(main(d))
"""


def test_service_runs_without_aiohttp():
    out = subprocess.run(
        [sys.executable, "-c", NO_AIOHTTP, json.dumps(MODEL), json.dumps(ENGINE)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    sent = result["sent"]
    assert len(sent) == 3 and all(isinstance(n, int) and n > 0 for n in sent[:2])
    assert sent[2] == {"type": "synthesis_complete", "chunk_id": 2}
    assert not result["aiohttp_loaded"] and result["active"] == 0
    assert "aiohttp" in result["create_app_error"]
