"""Microbenchmark: the transformer-stack CUDA kernel against the plain stack.

The port's `tools/bench_tstack.py`. The kernel is `ops.transformer_stack`
(`csrc/transformer_stack.cu`, bf16 on the tensor cores), the plain path
`layers.transformer_stack` (what the acoustic model runs with `acoustic_pallas` off).
The JAX tool's three cases, D 256, 4 heads, F 1024, 4 layers, bf16, mask all ones:
the encoder at B=16 L=64 and the decoder at B=16 T=512 (full attention), and the
decoder at B=8 T=768 with block-local attention (window 64).

Each case prints `plain_ms` (the JAX tool's `xla_ms`), `fused_ms`, `speedup`, the
device-busy ms of one pass of each, and `max_abs_err`: the kernel's output against
its plain twin `ops.transformer_stack.transformer_stack_plain` on the same input.
Times are `_bench_util.timeit`'s (K eager calls, one synchronize; host cost included).

    python -m gonova_tts_tpu_torch.tools.bench_tstack [--device cpu]

On the CPU the wrapper runs its plain twin, so `fused_ms` there times that.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Sequence, Tuple

import torch

from ..device import resolve_device
from ..models import layers
from ..ops import transformer_stack as ts_op
from ._bench_util import device_ms, timeit

K = 64
CASES: Tuple[Tuple[str, int, int, object], ...] = (
    ("encoder_B16_T64", 16, 64, None),
    ("decoder_B16_T512", 16, 512, None),
    ("decoder_B8_T768_local64", 8, 768, 64),
)


def run(device, d: int = 256, heads: int = 4, ff: int = 1024, n_layers: int = 4,
        cases: Sequence = CASES, k: int = K, repeats: int = 5) -> Dict[str, dict]:
    dev = resolve_device(device)
    p = layers.TransformerStack(torch.Generator().manual_seed(0), n_layers, d, heads, ff, 3).to(dev).eval()
    packed = ts_op.pack_params(p, torch.bfloat16)
    results = {}
    g = torch.Generator().manual_seed(1)
    for name, b, t, window in cases:
        x = torch.randn((b, t, d), generator=g).to(dev, torch.bfloat16)
        mask = torch.ones((b, t), dtype=torch.float32, device=dev)

        def plain_fn(x, mask=mask, window=window):
            return layers.transformer_stack(p, x, heads, mask, torch.bfloat16, attention_window=window)

        def fused_fn(x, mask=mask, window=window):
            return ts_op.transformer_stack(x, mask, packed, heads, window=window, bf16=True)

        with torch.inference_mode():
            err = (fused_fn(x).float() - ts_op.transformer_stack_plain(x, mask, packed, heads, window, True).float())
        ms_plain = timeit(plain_fn, x, k=k, repeats=repeats)
        ms_fused = timeit(fused_fn, x, k=k, repeats=repeats)
        results[name] = {
            "plain_ms": round(ms_plain, 3), "fused_ms": round(ms_fused, 3),
            "speedup": round(ms_plain / ms_fused, 2),
            "plain_device_ms": device_ms(dev, plain_fn, x), "fused_device_ms": device_ms(dev, fused_fn, x),
            "max_abs_err": float(err.abs().max()),
        }
        print(json.dumps({name: results[name]}), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
