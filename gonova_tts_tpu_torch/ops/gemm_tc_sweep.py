"""Time the bf16 tensor-core GEMM at every tile and several K splits, on the card.

    python -m gonova_tts_tpu_torch.ops.gemm_tc_sweep [--splits 1,2,3]

For each of the six serving products of the two stacks and each row count M = 4 * T,
prints one JSON line: the device time (ms, from a replayed CUDA graph of 20 calls)
of every (warpgroups, tile columns, split) the kernel takes, and which of them
`gemm_tc.plan` picks. This is the measurement behind the planner's constants
(TILES' order, TARGET_BLOCKS, MAX_SPLIT, MIN_TILES_PER_SPLIT, SPLIT_MAX_N).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from . import gemm_tc as g

PRODUCTS = (  # name, K per tap, taps, N, epilogue
    ("qkv", 256, 1, 768, g.EPI_BIAS), ("out-proj", 256, 1, 256, g.EPI_RESID_MASK),
    ("conv-ffn1", 256, 3, 1024, g.EPI_BIAS_RELU), ("conv-ffn2", 1024, 3, 256, g.EPI_RESID_MASK),
    ("vocos-w1", 512, 1, 1536, g.EPI_GELU), ("vocos-w2", 1536, 1, 512, g.EPI_GAMMA_RESID),
)
SPLITS = (1, 2, 3, 4, 6, 8)


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of `fn` in ms: `reps` calls captured into a CUDA graph
    and replayed five times, so that the host's launch cost (which exceeds a small
    kernel's time) is not in it."""
    fn()
    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.Stream()):  # capture wants a warm-up off the default stream
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_tc_sweep: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf = lambda x: torch.as_tensor(x.astype(np.float32), device=dev).bfloat16()  # noqa: E731
    splits = SPLITS
    if "--splits" in sys.argv:
        splits = tuple(int(v) for v in sys.argv[sys.argv.index("--splits") + 1].split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia-smi": smi}), flush=True)
    for name, cin, taps, n, epi in PRODUCTS:
        k = taps * cin
        w = bf(rng.standard_normal((k, n)) / np.sqrt(k))
        wt = w.t().contiguous()
        bias = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
        for t in (64, 320, 512, 2048):
            b = 4
            a, resid = bf(rng.standard_normal((b, t, cin))), bf(rng.standard_normal((b, t, n)))
            mask = torch.ones((b, t), device=dev)
            seqs, rows = (b, t) if taps == 3 else (1, b * t)
            rows_2d = (g.im2col3(a) if taps == 3 else a).reshape(b * t, k)  # the bare product's A'
            times = {}
            for wgs, bn in g.TILES:
                for split in splits:
                    if (k // g.BK) % split or k // g.BK // split < 2:
                        continue
                    fn = lambda: g.gemm_tc(a, w, epi, bias, resid, mask, bias, taps, wt=wt, force_plan=(wgs, bn, split))  # noqa: E731,B023
                    times[f"{wgs}x{bn}/{split}"] = round(graph_ms(fn) * 1e3, 2)
            picked = g.plan(seqs, rows, n, k)
            print(json.dumps({
                "product": name, "M": b * t, "N": n, "K": k, "us": times,
                "plan": f"{picked[0]}x{picked[1]}/{picked[2]}", "best": min(times, key=times.get),
                "matmul_us": round(graph_ms(lambda: torch.matmul(rows_2d, w)) * 1e3, 2),
            }), flush=True)


if __name__ == "__main__":
    main()
