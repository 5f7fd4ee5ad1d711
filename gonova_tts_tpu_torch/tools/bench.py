"""Headline benchmark of the port: audio-seconds per second at batch 16, and TTFA.

The port's `bench.py` (the JAX package's headline benchmark), run by
`gonova-tts-torch bench`:

    gonova-tts-torch bench [--device cpu]
    python -m gonova_tts_tpu_torch.tools.bench [--device cpu]

The workload is the JAX bench's exactly: `ModelConfig()` and `EngineConfig()`, 16
utterances of 64 tokens (`np.random.default_rng(0)`), exaggeration 0.5, fixed
durations of 5 frames a token (so the work does not depend on the weights, which are
the port's seeded init), bf16 on a card and f32 on the CPU. The JAX bench's two
dispatch modes are timed and, as there, the better one is the headline (`mode`); the
engine serves two-stage alone, and one-graph is timed only for the JAX bench's
detail keys and headline rule:

  * one-graph: `acoustic.forward` at the static worst case T = 64 * max_frames_per_token
    frames, then `tts.vocode`;
  * two-stage: `acoustic.encode`, then `acoustic.decode` at the engine's frame bucket
    covering the workload plus the stream context, with the one-graph frame count's
    attention choice, then `tts.vocode`. The two halves are timed apart and added, so
    the engine's one [B]-int32 readback between them is left out, as in JAX.

Each pass is timed by `_bench_util.timeit` (K eager calls, one synchronize, no
subtraction: the host's launch cost is included) and its device-busy time read by
torch.profiler. TTFA: one batch-1 acoustic pass, the first stride + 2 * context frame
window vocoded, the first chunk copied to the host; p50 and p90 over 15 runs.

Output: a `{"detail": ...}` line (the JAX bench's fields, plus each mode's wall and
device ms a pass and the device's idle share), then the contract's four keys. With no
card, unless `--device cpu`, one `{"error": "cuda_unavailable", ...}` line and exit 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..device import resolve_device
from ..models import acoustic, tts
from ._bench_util import device_ms, device_name, idle_share, sync, timeit

BASELINE_AUDIO_SEC_PER_SEC = 60.0  # the reference's RTX 4090 aggregate (BASELINE.md), as in JAX
METRIC = "audio_sec_per_sec_per_chip"
K_INNER = 32  # passes a timed call on the card (2 on the CPU)
BATCH, BUCKET, FRAMES_PER_TOKEN = 16, 64, 5  # 5 frames ≈ 53 ms a phoneme at hop 256 / 24 kHz
EXAGGERATION = 0.5


@dataclass(frozen=True)
class Workload:
    batch: int
    bucket: int
    frames_per_token: int
    t_full: int  # one-graph frames: bucket * max_frames_per_token
    fb: int  # two-stage frame bucket
    w_first: int  # TTFA: the first streamed vocoder window, stride + 2 * context
    audio_sec: float  # audio of one pass


def workload(cfg: ModelConfig, ecfg: EngineConfig, batch: int = BATCH, bucket: int = BUCKET,
             frames_per_token: int = FRAMES_PER_TOKEN) -> Workload:
    """The JAX bench's shapes: the engine's two-stage dispatch takes the smallest
    configured frame bucket covering total_frames + stream context."""
    t_full = bucket * cfg.max_frames_per_token
    need = bucket * frames_per_token + ecfg.stream_context_frames
    fb = min(min((x for x in ecfg.vocode_frame_buckets if x >= need), default=t_full), t_full)
    stride = ecfg.stream_chunk_frames
    ctx = min(ecfg.stream_context_frames, stride)
    audio_sec = batch * bucket * frames_per_token * cfg.hop_length / cfg.sample_rate
    return Workload(batch, bucket, frames_per_token, t_full, fb, stride + 2 * ctx, audio_sec)


def inputs(cfg: ModelConfig, wl: Workload, dev) -> Dict[str, torch.Tensor]:
    """The JAX bench's inputs, from one `np.random.default_rng(0)`."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, 48, (wl.batch, wl.bucket))
    speaker = rng.standard_normal((wl.batch, cfg.speaker_dim))
    return {
        "tokens": torch.as_tensor(tokens, dtype=torch.int32, device=dev),
        "mask": torch.ones((wl.batch, wl.bucket), dtype=torch.float32, device=dev),
        "speaker": torch.as_tensor(speaker, dtype=torch.float32, device=dev),
        "exagg": torch.full((wl.batch,), EXAGGERATION, dtype=torch.float32, device=dev),
        "durations": torch.full((wl.batch, wl.bucket), wl.frames_per_token, dtype=torch.int32, device=dev),
    }


def passes(params: Mapping, cfg: ModelConfig, wl: Workload, x: Mapping[str, torch.Tensor],
           dtype: torch.dtype) -> Dict[str, Callable]:
    """The bench's timed functions over `params` (a `tts.TTS`): `one_graph(speaker)`,
    `encode(speaker)` → (enc, spk), `decode(enc, spk)`, and TTFA's
    `acoustic_first(speaker[:1])` → the first window's mel and `vocode_window(mel)`."""
    tokens, mask, exagg, durations = x["tokens"], x["mask"], x["exagg"], x["durations"]
    ac = params["acoustic"]

    def one_graph(speaker):
        mel = acoustic.forward(ac, tokens, mask, speaker, exagg, cfg, durations=durations, dtype=dtype)["mel"]
        return tts.vocode(params, mel, cfg, dtype=dtype)

    def encode(speaker):
        e = acoustic.encode(ac, tokens, mask, speaker, exagg, cfg, durations=durations, dtype=dtype)
        return e["enc"], e["spk"]

    def decode(enc, spk):
        d = acoustic.decode(ac, enc, spk, durations, mask, wl.fb, cfg, dtype=dtype, local_attention_from=wl.t_full)
        return tts.vocode(params, d["mel"], cfg, dtype=dtype)

    def acoustic_first(spk1):
        mel = acoustic.forward(ac, tokens[:1], mask[:1], spk1, exagg[:1], cfg, durations=durations[:1],
                               dtype=dtype)["mel"]
        return mel[:, : wl.w_first]

    def vocode_window(window):
        return tts.vocode(params, window, cfg, dtype=dtype)

    return {"one_graph": one_graph, "encode": encode, "decode": decode,
            "acoustic_first": acoustic_first, "vocode_window": vocode_window}


def run(cfg: ModelConfig, ecfg: EngineConfig, device, reps: Optional[int] = None) -> Tuple[dict, dict]:
    """(the detail line's fields, the contract line) of one bench run on `device`.
    `reps` overrides the timed repeats (5 on a card, 2 on the CPU, as in JAX)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    k = K_INNER if on_card else 2
    repeats = reps or (5 if on_card else 2)
    wl = workload(cfg, ecfg)
    params = tts.TTS(cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    x = inputs(cfg, wl, dev)
    fns = passes(params, cfg, wl, x, dtype)
    with torch.inference_mode():
        enc0, spk0 = fns["encode"](x["speaker"])

    wall_one = timeit(fns["one_graph"], x["speaker"], k=k, repeats=repeats)
    wall_two = (timeit(fns["encode"], x["speaker"], k=k, repeats=repeats)
                + timeit(fns["decode"], enc0, spk0, k=k, repeats=repeats))
    busy_one = device_ms(dev, fns["one_graph"], x["speaker"])
    busy_enc, busy_dec = device_ms(dev, fns["encode"], x["speaker"]), device_ms(dev, fns["decode"], enc0, spk0)
    busy_two = None if None in (busy_enc, busy_dec) else busy_enc + busy_dec
    v_one = wl.audio_sec / (wall_one / 1e3)
    v_two = wl.audio_sec / (wall_two / 1e3)
    value, mode = max((v_one, "one_graph"), (v_two, "two_stage"))

    spk1 = x["speaker"][:1]
    ttfas = []
    with torch.inference_mode():
        fns["vocode_window"](fns["acoustic_first"](spk1)).cpu().numpy()  # warm
        for _ in range(15 if on_card else 3):
            sync()
            t0 = time.perf_counter()
            fns["vocode_window"](fns["acoustic_first"](spk1)).cpu().numpy()
            ttfas.append(time.perf_counter() - t0)

    name, dname = device_name(dev), "bf16" if on_card else "f32"
    detail = {
        "mode": mode, "one_graph": round(v_one, 2), "two_stage_compute": round(v_two, 2),
        "ttfa_p50_ms": round(1e3 * float(np.median(ttfas)), 1),
        "ttfa_p90_ms": round(1e3 * float(np.percentile(ttfas, 90)), 1),
        "device": name, "dtype": dname,
        "one_graph_wall_ms": wall_one, "one_graph_device_ms": busy_one,
        "one_graph_idle": idle_share(busy_one, wall_one),
        "two_stage_wall_ms": wall_two, "two_stage_device_ms": busy_two,
        "two_stage_idle": idle_share(busy_two, wall_two),
    }
    result = {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": f"audio-seconds generated per wall-second per card ({name}; batch 16, full pipeline, {dname})",
        "vs_baseline": round(value / BASELINE_AUDIO_SEC_PER_SEC, 3),
    }
    return detail, result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device or "cuda").type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"error": "cuda_unavailable", "metric": METRIC,
                          "detail": "no CUDA device; pass --device cpu to run on the CPU"}))
        return 1
    detail, result = run(ModelConfig(), EngineConfig(), args.device)
    print(json.dumps({"detail": detail}))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
