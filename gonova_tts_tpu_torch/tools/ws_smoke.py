"""WS smoke of a trained checkpoint through the port's service.

The port's copy of the JAX package's tools/ws_smoke.py, with its flags and JSON
keys. Boots the service in process on `Config()` with `model.model_path` =
`--checkpoint`, reads `/health`, registers the corpus' `ref_spk_mid.wav` over the WS
protocol, synthesizes held-in sentences in that voice, and reports time to first
audio, wall time, the realtime factor and signal sanity as one JSON object.

The transport follows from what is installed: with aiohttp, the service's app
behind aiohttp's TestServer and TestClient (the app `serve` binds to a port);
without it, `TTSService.handle_connection` over an in-memory socket
(`service/memory_socket.py`) and `TTSService.health()`. The messages are the same
either way; `transport` says which ran.

    python -m gonova_tts_tpu_torch.tools.ws_smoke --checkpoint CKPT --corpus DIR [--repeat 2] [--out out.wav] [--device cpu]

Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np

from ..config import Config
from ..service import TTSService, server
from ..service.memory_socket import MemorySocket
from ..train.synth_corpus import DEFAULT_SENTENCES
from ..utils import write_wav

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "assets", "checkpoints", "demo_ema_f16.npz")
TIMEOUT_S = 600


def aiohttp_test_utils():
    """aiohttp's test server and client, or None where aiohttp is not installed."""
    try:
        from aiohttp.test_utils import TestClient, TestServer
    except ImportError:
        return None
    return TestClient, TestServer


class AiohttpLink:
    """The service's app behind aiohttp's TestServer, one WS connection."""

    transport = "aiohttp"

    def __init__(self, cfg: Config, client_cls, server_cls):
        self.client = client_cls(server_cls(server.create_app(cfg)))
        self.ws = None

    async def start(self) -> None:
        await self.client.start_server()

    async def health(self) -> dict:
        resp = await self.client.get("/health")
        return await resp.json()

    async def connect(self) -> None:
        self.ws = await self.client.ws_connect("/v1/stream/tts")

    async def send(self, message: dict) -> None:
        await self.ws.send_json(message)

    async def receive(self):
        msg = await asyncio.wait_for(self.ws.receive(), TIMEOUT_S)
        if msg.type == server.WSMsgType.BINARY:
            return "binary", msg.data
        if msg.type == server.WSMsgType.TEXT:
            return "json", json.loads(msg.data)
        raise AssertionError(f"unexpected WS message: {msg.type}")

    async def close(self) -> None:
        if self.ws is not None:
            await self.ws.close()
        await self.client.close()


class MemoryLink:
    """`TTSService.handle_connection` over an in-memory socket, one connection."""

    transport = "memory"

    def __init__(self, cfg: Config):
        self.svc = TTSService(cfg)
        self.sock = self.conn = None

    async def start(self) -> None:
        await self.svc.start()

    async def health(self) -> dict:
        return self.svc.health()[1]

    async def connect(self) -> None:
        self.sock = MemorySocket()
        self.conn = asyncio.create_task(self.svc.handle_connection(self.sock, "ws-smoke"))

    async def send(self, message: dict) -> None:
        await self.sock.send(message)

    async def receive(self):
        return await self.sock.receive(TIMEOUT_S)

    async def close(self) -> None:
        if self.conn is not None:
            await self.sock.end()
            await self.conn
        await self.svc.shutdown()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=DEMO, help="npz or training root (default: the demo checkpoint)")
    ap.add_argument("--corpus", default="corpus", help="synth_corpus output dir holding ref_spk_mid.wav")
    ap.add_argument("--sentences", type=int, default=3)
    ap.add_argument("--voices-dir", default=None, help="voice cache dir (default: a temporary directory)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sr", type=int, default=24000,
                    help="served model sample rate (audio_s/realtime_x math + output WAV)")
    ap.add_argument("--repeat", type=int, default=0,
                    help="re-send the same request N times and report the last pass as "
                         "ttfa_steady_ms/wall_steady_s (first-request one-time costs excluded)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


async def drive(args: argparse.Namespace, cfg: Config) -> dict:
    utils = aiohttp_test_utils()
    t0 = time.perf_counter()
    link = AiohttpLink(cfg, *utils) if utils else MemoryLink(cfg)
    await link.start()
    report: dict = {"checkpoint": args.checkpoint, "load_s": round(time.perf_counter() - t0, 1),
                    "transport": link.transport}
    try:
        health = await link.health()
        report["health"] = health["status"]
        report["backend"] = health.get("tpu", {}).get("backend")

        await link.connect()
        with open(os.path.join(args.corpus, "ref_spk_mid.wav"), "rb") as f:
            await link.send({"type": "register_voice", "voice_id": "smoke_mid",
                             "reference_audio": base64.b64encode(f.read()).decode()})
        kind, msg = await link.receive()
        if (kind, msg) != ("json", {"type": "voice_registered", "voice_id": "smoke_mid"}):
            raise AssertionError(f"voice registration answered {msg!r}")

        text = " ".join(DEFAULT_SENTENCES[: args.sentences])

        async def one_request():
            t0 = time.perf_counter()
            await link.send({"type": "synthesize", "text": text, "voice_id": "smoke_mid"})
            chunks, ttfa = [], None
            while True:
                kind, data = await link.receive()
                if kind == "binary":
                    if ttfa is None:
                        ttfa = time.perf_counter() - t0
                    chunks.append(np.frombuffer(data, dtype=np.float32))
                elif data.get("type") == "synthesis_complete":
                    return chunks, ttfa, data, time.perf_counter() - t0
                elif data.get("type") == "error":
                    # The server's error, not a zero-chunk concatenate below.
                    raise AssertionError(f"server error frame: {data.get('message')}")

        chunks, ttfa, final, total = await one_request()
        # Steady state (--repeat): the first request on a freshly registered voice pays
        # one-time work; the repeats measure the warmed serving path.
        for _ in range(max(0, args.repeat)):
            chunks, ttfa2, final, total2 = await one_request()
            report["ttfa_steady_ms"] = round(ttfa2 * 1000, 1)
            report["wall_steady_s"] = round(total2, 2)

        if not chunks:
            raise AssertionError(f"no audio chunks received (final frame: {final})")
        audio = np.concatenate(chunks)
        secs = len(audio) / args.sr
        report.update({
            "sentences": args.sentences,
            "chunks": len(chunks),
            "final_chunk_id": final["chunk_id"],
            "ttfa_ms": round(ttfa * 1000, 1),
            "wall_s": round(total, 2),
            "audio_s": round(secs, 2),
            "realtime_x": round(secs / total, 1),
            "rms": round(float(np.sqrt(np.mean(audio**2))), 4),
            "peak": round(float(np.abs(audio).max()), 4),
            "finite": bool(np.isfinite(audio).all()),
        })
        if args.out:
            write_wav(args.out, audio, args.sr)
            report["wav"] = args.out
    finally:
        await link.close()
    return report


def run(args: argparse.Namespace, cfg: Optional[Config] = None) -> dict:
    """The smoke's report. `cfg` replaces `Config()` (checkpoint, voice directory, no
    default voice and device set from `args`)."""
    cfg = (cfg or Config()).model_copy(deep=True)
    cfg.model.model_path = args.checkpoint
    cfg.voice_cloning.default_voice_path = None
    cfg.logging.level = "WARNING"
    if args.device:
        cfg.model.device = args.device
    if args.voices_dir:
        cfg.voice_cloning.cache_dir = args.voices_dir
        return asyncio.run(drive(args, cfg))
    with tempfile.TemporaryDirectory() as voices:
        cfg.voice_cloning.cache_dir = voices
        return asyncio.run(drive(args, cfg))


def main(argv=None, cfg: Optional[Config] = None) -> dict:
    report = run(parse_args(argv), cfg)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
