"""NovaGAN on the card: both layouts of the generator, its MRF stages, and a conv sweep.

The port's `tools/bench_hifigan.py`, at B=16 T=320 (the 64-token bucket at 5 frames a
token), `ModelConfig(vocoder_family="hifigan")` at full width, bf16, the seeded init.
The HiFi-GAN family has no hand-written kernel in either package: every conv here runs
on cuDNN.

  1. the full generator pass in the plain layout (`models/vocoder.py`) and in the
     lane-folded layout the JAX package shaped for the TPU (`models/vocoder_folded.py`),
     with audio-s/s and `folded_speedup` = plain ms / folded ms (below 1: the fold
     loses);
  2. each upsample level's MRF (three resblocks and their mean) alone, at its input
     shape after the transposed conv;
  3. one k=7 conv at fixed FLOPs over channel widths C 16 / 32 / 64 / 128 (T * C^2
     constant): flat in C means the narrow convs cost what the wide one does.

Each time also has a `*_device_ms` twin (the device-busy ms of one pass). Times are
`_bench_util.timeit`'s (K eager calls, one synchronize; host cost included).

    python -m gonova_tts_tpu_torch.tools.bench_hifigan [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence, Tuple

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import layers, vocoder, vocoder_folded
from ._bench_util import device_ms, timeit

K = 8  # a generator pass is tens of ms: keep a timed call short
SWEEP: Tuple[Tuple[int, int], ...] = ((16, 65536), (32, 16384), (64, 4096), (128, 1024))


def run(device, b: int = 16, t: int = 320, cfg: Optional[ModelConfig] = None, sweep: Sequence = SWEEP,
        k: int = K, repeats: int = 3) -> dict:
    dev = resolve_device(device)
    bf16 = torch.bfloat16
    cfg = (cfg or ModelConfig()).model_copy(update={"vocoder_family": "hifigan"})
    params = vocoder.init(torch.Generator().manual_seed(0), cfg).to(dev).eval()
    g = torch.Generator().manual_seed(1)
    mel = torch.randn((b, t, cfg.n_mels), generator=g).to(dev)
    audio_sec = b * t * vocoder.upsample_factor(cfg) / cfg.sample_rate
    results = {}

    def timed(key, fn, arg, k=k):
        ms = timeit(fn, arg, k=k, repeats=repeats)
        results[key] = round(ms, 3)
        results[key.replace("_ms", "_device_ms")] = device_ms(dev, fn, arg)
        return ms

    ms = timed("full_pass_ms", lambda m: vocoder.forward(params, m, cfg, dtype=bf16), mel)
    results["audio_sec_per_sec"] = round(audio_sec / (ms / 1e3), 1)
    print(json.dumps(results), flush=True)

    ms_f = timed("folded_pass_ms", lambda m: vocoder_folded.forward(params, m, cfg, dtype=bf16), mel)
    results["folded_audio_sec_per_sec"] = round(audio_sec / (ms_f / 1e3), 1)
    results["folded_speedup"] = round(ms / ms_f, 2)
    print(json.dumps(results), flush=True)

    t_cur, ch = t, cfg.upsample_initial_channel
    for i, rate in enumerate(cfg.upsample_rates):
        t_cur, ch_out = t_cur * rate, ch // 2
        x = torch.randn((b, t_cur, ch_out), generator=g).to(dev, bf16)
        mrf = params["mrfs"][i]

        def mrf_fn(x, mrf=mrf):
            acc = None
            for block, rd in zip(mrf, cfg.resblock_dilations):
                y = vocoder._resblock_apply(block, x, rd, dtype=bf16)
                acc = y if acc is None else acc + y
            return acc / float(len(mrf))

        timed(f"mrf_stage{i}_T{t_cur}_C{ch_out}_ms", mrf_fn, x)
        ch = ch_out
        print(json.dumps(results), flush=True)

    for c, tc in sweep:
        p = layers.conv1d_init(torch.Generator().manual_seed(9), c, c, 7).to(dev)
        x = torch.randn((b, tc, c), generator=g).to(dev, bf16)
        timed(f"conv_fixedflop_C{c}_T{tc}_ms", lambda x, p=p: layers.conv1d(p, x, dtype=bf16), x, k=4 * k)
        print(json.dumps(results), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
