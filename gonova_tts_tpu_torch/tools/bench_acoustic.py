"""A/B: the acoustic pass and the full pipeline with `acoustic_pallas` off and on.

The port's `tools/bench_acoustic.py`. `tools.bench_tstack` times the stacks alone;
this times what serving pays: `acoustic.forward` (embedding, both stacks, the
predictors, the length regulator, pitch conditioning and masking) and that pass plus
`tts.vocode`, at the bench's workload (batch 16, the 64-token bucket, 5 frames a
token, bf16, the seeded init), once on the plain stacks and once with both stacks
through `csrc/transformer_stack.cu`. This is the reading the card's default for
`EngineConfig.acoustic_pallas` is to be decided from.

Keys: the JAX tool's, `xla` read as `plain` (`acoustic_plain_ms`, `pipeline_plain_ms`,
`acoustic_fused_ms`, `pipeline_fused_ms`, both speedups), each pass's device-busy ms,
and `acoustic_max_abs_err`: the fused arm's mel against the plain arm's.

    python -m gonova_tts_tpu_torch.tools.bench_acoustic [--batch 16] [--bucket 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import acoustic, tts
from ._bench_util import device_ms, timeit

K = 64


def run(device, batch: int = 16, bucket: int = 64, cfg: Optional[ModelConfig] = None, k: int = K,
        repeats: int = 5) -> dict:
    dev = resolve_device(device)
    cfg_off = (cfg or ModelConfig()).model_copy(update={"acoustic_pallas": False})
    cfg_on = cfg_off.model_copy(update={"acoustic_pallas": True})
    params = tts.TTS(cfg_off, torch.Generator().manual_seed(0)).to(dev).eval()
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(4, 48, (batch, bucket)), dtype=torch.int32, device=dev)
    mask = torch.ones((batch, bucket), dtype=torch.float32, device=dev)
    spk = torch.as_tensor(rng.standard_normal((batch, cfg_off.speaker_dim)), dtype=torch.float32, device=dev)
    exagg = torch.full((batch,), 0.5, dtype=torch.float32, device=dev)
    durations = torch.full((batch, bucket), 5, dtype=torch.int32, device=dev)

    results, mels = {"batch": batch, "bucket": bucket}, {}
    for name, cfg_ in (("plain", cfg_off), ("fused", cfg_on)):
        def ac_fn(spk, cfg_=cfg_):
            return acoustic.forward(params["acoustic"], tokens, mask, spk, exagg, cfg_,
                                    durations=durations, dtype=torch.bfloat16)["mel"]

        def pipe_fn(spk, cfg_=cfg_):
            return tts.vocode(params, ac_fn(spk), cfg_, dtype=torch.bfloat16)

        with torch.inference_mode():
            mels[name] = ac_fn(spk).float()
        results[f"acoustic_{name}_ms"] = round(timeit(ac_fn, spk, k=k, repeats=repeats), 3)
        results[f"pipeline_{name}_ms"] = round(timeit(pipe_fn, spk, k=k, repeats=repeats), 3)
        results[f"acoustic_{name}_device_ms"] = device_ms(dev, ac_fn, spk)
        results[f"pipeline_{name}_device_ms"] = device_ms(dev, pipe_fn, spk)
        print(json.dumps(results), flush=True)

    results["acoustic_speedup"] = round(results["acoustic_plain_ms"] / results["acoustic_fused_ms"], 3)
    results["pipeline_speedup"] = round(results["pipeline_plain_ms"] / results["pipeline_fused_ms"], 3)
    results["acoustic_max_abs_err"] = float((mels["fused"] - mels["plain"]).abs().max())
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--bucket", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.batch, args.bucket)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
