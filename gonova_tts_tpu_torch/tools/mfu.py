"""MFU of the headline bench workload: FLOPs a pass over wall time a pass over peak.

The port's `tools/mfu.py`. The FLOPs a pass are counted on the exact graphs
`tools.bench` times (the same model, shapes and dispatch split) by
`torch.utils.flop_counter.FlopCounterMode` on the `meta` device: products and
convolutions only, on the plain path (the kernel switches forced off, so the count is
the same whatever implements the work; the counter cannot see into a CUDA kernel).
XLA's `cost_analysis`, which the JAX tool reads, also counts elementwise operations,
so this count is a little lower for the same graph. Then

    MFU = FLOPs_per_pass / wall_per_pass / peak

where wall_per_pass = audio_s_per_pass / a measured audio-s/s (the bench's detail
line) and the peak is the card's dense bf16 rate:

    python -m gonova_tts_tpu_torch.tools.mfu --one-graph AUDIO_S_PER_S --two-stage AUDIO_S_PER_S

The default peak comes from `PEAK_TFLOPS_BF16`, keyed by the name of the card that
`--device` names (CUDA unless `--device cpu`); a card not in the table, or the CPU,
needs `--peak-tflops`.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..config import EngineConfig, ModelConfig
from ..device import resolve_device
from ..models import tts
from . import bench
from ._bench_util import device_name

# Dense bf16 tensor-core peak, TFLOP/s, at the card's full power limit (NVIDIA's data
# sheet; the kernel table's bounds use the same figure).
PEAK_TFLOPS_BF16 = {"NVIDIA H100 80GB HBM3": 989.0}


def pass_flops(cfg: ModelConfig, ecfg: EngineConfig) -> Dict[str, int]:
    """FLOPs of one pass of each of the bench's graphs: one_graph, encode, decode."""
    cfg = cfg.model_copy(update={"acoustic_pallas": False, "vocos_pallas": False})
    wl = bench.workload(cfg, ecfg)
    params = tts.TTS(cfg).to("meta").eval()
    x = bench.inputs(cfg, wl, "meta")
    fns = bench.passes(params, cfg, wl, x, torch.float32)

    def counted(fn, *args):
        with FlopCounterMode(display=False) as fc:
            out = fn(*args)
        return fc.get_total_flops(), out

    with torch.inference_mode():
        one_graph, _ = counted(fns["one_graph"], x["speaker"])
        encode, (enc, spk) = counted(fns["encode"], x["speaker"])
        decode, _ = counted(fns["decode"], enc, spk)
    return {"one_graph": one_graph, "encode": encode, "decode": decode}


def peak_tflops(dev: torch.device, given: Optional[float]) -> float:
    if given is not None:
        return given
    name = device_name(dev)
    if name not in PEAK_TFLOPS_BF16:
        raise SystemExit(f"no peak known for {name!r}: pass --peak-tflops")
    return PEAK_TFLOPS_BF16[name]


def report(cfg: ModelConfig, ecfg: EngineConfig, one_graph: float, two_stage: float, peak: float) -> dict:
    """The JAX tool's JSON: the workload, the peak and one row per measured mode."""
    wl = bench.workload(cfg, ecfg)
    flops = pass_flops(cfg, ecfg)

    def row(name, f, throughput):
        wall = wl.audio_sec / throughput
        return {
            "mode": name,
            "gflops_per_pass": round(f / 1e9, 1),
            "wall_ms_per_pass": round(wall * 1e3, 3),
            "audio_s_per_s": throughput,
            "mfu_pct": round(100.0 * f / wall / (peak * 1e12), 2),
        }

    out = {
        "workload": f"B={wl.batch} L={wl.bucket} fpt={wl.frames_per_token} (T_one={wl.t_full}, T_two={wl.fb})",
        "peak_tflops_bf16": peak,
        "rows": [row("one_graph", flops["one_graph"], one_graph)],
    }
    if two_stage > 0:
        out["rows"].append(row("two_stage", flops["encode"] + flops["decode"], two_stage))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--one-graph", type=float, required=True,
                    help="measured one-graph audio-s/s (the bench's detail line)")
    ap.add_argument("--two-stage", type=float, default=0.0,
                    help="measured two-stage audio-s/s (0 = skip)")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the card's dense bf16 peak, TFLOP/s (default: by the card's name)")
    ap.add_argument("--device", default=None, help="the card whose peak applies: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = report(ModelConfig(), EngineConfig(), args.one_graph, args.two_stage, peak_tflops(dev, args.peak_tflops))
    out["device"] = device_name(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
