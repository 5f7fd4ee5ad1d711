"""Benchmark suite: the five BASELINE.json workload configs, one JSON line each.

The port's `bench_suite.py`, over the port's `TTSEngine`, `DynamicBatcher`,
`text.segment_text` and `audio.stitch`:

  1. single_short   — one ~10-word utterance, single-stream latency + RTF
  2. batched_32     — 32 concurrent short utterances through the dynamic batcher
  3. longform_5k    — 5k-char article: segment → per-chunk synth → stitched WAV
  4. multi_speaker  — several voices through the same device shapes (`recompiles`
                      reads the engine's `stats["compiles"]`: distinct device shapes)
  5. streaming_qps  — fixed request rate; p50/p90 time-to-first-audio

    python -m gonova_tts_tpu_torch.tools.bench_suite [--tiny] [--config N] [--device cpu]

`--tiny` uses the small test model; the default is the production config. The engine
is a fresh seeded init (seed 0) on CUDA unless `--device cpu`, warmed up at every shape
the timed regions hit. The headline single number is `tools.bench`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np

from ..audio import stitch
from ..config import Config, EngineConfig, ModelConfig
from ..engine import DynamicBatcher, TTSEngine
from ..text import segment_text

SHORT_TEXTS = [
    "The weather today looks bright and clear over the hills.",
    "Please remember to close the windows before you leave.",
    "Our train departs from the second platform at noon.",
    "She found a small red notebook under the kitchen table.",
    "The river rises quickly after heavy summer rain.",
    "He plays the piano every evening after dinner.",
    "Fresh bread and coffee make the morning better.",
    "The museum opens at nine and closes at five.",
]

LONGFORM_SENTENCE = (
    "The expedition started before dawn, when the valley was still wrapped in mist and "
    "the first light had not yet touched the ridgeline above the camp. "
)

TINY_MODEL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1,
    speaker_dim=32, upsample_initial_channel=32, vocos_dim=128, vocos_ff=256,
    vocos_layers=2, compute_dtype="float32",
)


def suite_config(tiny: bool, device: str) -> Config:
    """The JAX suite's config: the tiny test model, or the production config with
    warm-up shapes covering every shape the timed regions hit ([4, 64] for the
    streaming config's admission groups, [16, 128] / [16, 192] for the long-form
    sentence buckets)."""
    cfg = Config()
    if tiny:
        cfg.model = ModelConfig(**TINY_MODEL)
        cfg.engine = EngineConfig(
            warmup_shapes=[[1, 64], [4, 64], [8, 64], [16, 128], [16, 192]],
            batch_buckets=[1, 4, 8, 16],
        )
    else:
        cfg.engine.warmup_shapes = [[1, 64], [4, 64], [8, 64], [16, 64], [16, 128], [16, 192]]
    cfg.model.device = device
    return cfg


def make_engine(tiny: bool, device: str = "cuda") -> TTSEngine:
    eng = TTSEngine(suite_config(tiny, device))
    eng.load(warmup=True)
    return eng


def _emit(name: str, **fields) -> dict:
    line = {"config": name, **{k: round(v, 4) if isinstance(v, float) else v for k, v in fields.items()}}
    print(json.dumps(line), flush=True)
    return line


def bench_single_short(eng: TTSEngine) -> dict:
    text = SHORT_TEXTS[0]
    list(eng.synthesize_stream(text))  # warm path
    t0 = time.perf_counter()
    chunks = list(eng.synthesize_stream(text))
    wall = time.perf_counter() - t0
    audio_sec = sum(len(c) for c in chunks) / eng.sample_rate
    return _emit("single_short", wall_s=wall, audio_s=audio_sec,
                 rtf=wall / max(audio_sec, 1e-9), x_realtime=audio_sec / max(wall, 1e-9))


def bench_batched_32(eng: TTSEngine) -> dict:
    texts = [SHORT_TEXTS[i % len(SHORT_TEXTS)] + f" Request {i}." for i in range(32)]

    async def run():
        batcher = DynamicBatcher(eng, max_batch=16, window_ms=20)
        await batcher.start()
        await batcher.submit(texts[0])  # warm
        t0 = time.perf_counter()
        outs = await asyncio.gather(*[batcher.submit(t) for t in texts])
        wall = time.perf_counter() - t0
        await batcher.stop()
        return outs, wall, dict(batcher.metrics)

    outs, wall, metrics = asyncio.run(run())
    audio_sec = sum(len(o) for o in outs) / eng.sample_rate
    return _emit("batched_32", wall_s=wall, audio_s=audio_sec,
                 agg_audio_sec_per_sec=audio_sec / max(wall, 1e-9),
                 batches=metrics["batches"], max_batch_seen=metrics["max_batch_seen"])


def bench_longform_5k(eng: TTSEngine) -> dict:
    article = (LONGFORM_SENTENCE * 34)[:5000]
    sentences = segment_text(article)
    eng.synthesize_batch(sentences[:1])  # warm
    t0 = time.perf_counter()
    parts = []
    for i in range(0, len(sentences), 16):
        parts.extend(eng.synthesize_batch(sentences[i : i + 16]))
    audio = stitch(parts, overlap=64)
    wall = time.perf_counter() - t0
    audio_sec = len(audio) / eng.sample_rate
    return _emit("longform_5k", chars=len(article), chunks=len(sentences), wall_s=wall,
                 audio_s=audio_sec, x_realtime=audio_sec / max(wall, 1e-9))


def bench_multi_speaker(eng: TTSEngine) -> dict:
    rng = np.random.default_rng(0)
    voices = [rng.standard_normal(eng.mcfg.speaker_dim).astype(np.float32) for _ in range(6)]
    voices = [v / np.linalg.norm(v) for v in voices]
    texts = [SHORT_TEXTS[i % len(SHORT_TEXTS)] for i in range(12)]
    eng.synthesize_batch(texts[:8], speakers=[voices[0]] * 8)  # warm
    compiles_before = eng.stats["compiles"]
    t0 = time.perf_counter()
    outs = eng.synthesize_batch(texts[:8], speakers=[voices[i % 6] for i in range(8)])
    wall = time.perf_counter() - t0
    audio_sec = sum(len(o) for o in outs) / eng.sample_rate
    return _emit("multi_speaker", voices=6, wall_s=wall, audio_s=audio_sec,
                 agg_audio_sec_per_sec=audio_sec / max(wall, 1e-9),
                 recompiles=eng.stats["compiles"] - compiles_before)


def bench_streaming_qps(eng: TTSEngine, qps: float = 4.0, n_requests: int = 12) -> dict:
    async def run():
        batcher = DynamicBatcher(eng, max_batch=8, window_ms=15)
        await batcher.start()
        await batcher.submit(SHORT_TEXTS[0])  # warm

        ttfas = []

        async def one(i):
            t0 = time.perf_counter()
            await batcher.submit(SHORT_TEXTS[i % len(SHORT_TEXTS)])
            ttfas.append(time.perf_counter() - t0)

        tasks = []
        for i in range(n_requests):
            tasks.append(asyncio.create_task(one(i)))
            await asyncio.sleep(1.0 / qps)
        await asyncio.gather(*tasks)
        await batcher.stop()
        return ttfas

    ttfas = asyncio.run(run())
    # SHORT_TEXTS are single sentences: through the service one sentence is one
    # batcher submit, the request's first and only chunk, so its completion time IS
    # the time to first audio. For multi-sentence requests it would not be.
    return _emit("streaming_qps", qps=qps, requests=n_requests,
                 p50_ttfa_ms=float(np.percentile(ttfas, 50)) * 1000,
                 p90_ttfa_ms=float(np.percentile(ttfas, 90)) * 1000)


BENCHES = {
    1: bench_single_short,
    2: bench_batched_32,
    3: bench_longform_5k,
    4: bench_multi_speaker,
    5: bench_streaming_qps,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="small test model (CI)")
    ap.add_argument("--config", type=int, default=None, help="run one config 1-5")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    eng = make_engine(args.tiny, args.device)
    for idx, fn in BENCHES.items():
        if args.config is None or args.config == idx:
            fn(eng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
