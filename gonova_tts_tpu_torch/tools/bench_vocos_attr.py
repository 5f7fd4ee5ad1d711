"""Attribution of the Vocos pass: where its time goes at the serving shape.

The port's `tools/bench_vocos_attr.py`, at B=16 T=320 (the 64-token bucket at 5
frames a token), C 512, F 1536, 8 blocks, bf16, the seeded init, each pass as serving
runs it (no autograd: every product in 128-row tiles, `layers.tiled_matmul`). The
keys keep the JAX tool's names; the card has no split between a vector unit and a
matrix unit, so here they time:

  full_ms                  `vocos.forward` (embed conv, 8 ConvNeXt blocks on the plain
                           path, LN, head, iSTFT), the default cartesian head;
  mlps_only_ms             the 16 MLP products alone, chained ([B*T, 512] @ [512, 1536],
                           tanh-GELU, @ [1536, 512]; one `torch.matmul` each, cuBLAS);
  vpu_only_ms              the blocks without their MLPs, x8: depthwise k=7 conv (cuDNN),
                           LayerNorm, layer scale, residual (elementwise launches);
  head_istft_ms            LN, the polar head's product, exp / cos / sin, the iDFT
                           product and overlap-add (a polar-head init: the head's width
                           differs from the cartesian one's);
  head_istft_cartesian_ms  the same with the cartesian head (rsqrt in place of cos/sin);
  full_cartesian_ms        the full pass with the cartesian head; the port's default
                           head is cartesian, so this times the same pass as full_ms.

Each key also has a `*_device_ms` twin: the device-busy ms of one pass.

    python -m gonova_tts_tpu_torch.tools.bench_vocos_attr [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..device import resolve_device
from ..models import layers, vocos
from ._bench_util import device_ms, timeit

K = 32


def run(device, b: int = 16, t: int = 320, cfg: Optional[ModelConfig] = None, k: int = K, repeats: int = 3) -> dict:
    dev = resolve_device(device)
    bf16 = torch.bfloat16
    cfg_c = (cfg or ModelConfig()).model_copy(update={"vocos_head": "cartesian", "vocos_pallas": False})
    cfg_p = cfg_c.model_copy(update={"vocos_head": "polar"})
    params_c = vocos.init(torch.Generator().manual_seed(0), cfg_c).to(dev).eval()
    params_p = vocos.init(torch.Generator().manual_seed(0), cfg_p).to(dev).eval()
    g = torch.Generator().manual_seed(1)
    mel = torch.randn((b, t, cfg_c.n_mels), generator=g).to(dev)
    x0 = torch.randn((b, t, cfg_c.vocos_dim), generator=g).to(dev, bf16)
    n_bins = cfg_c.n_fft // 2 + 1
    results = {}

    def timed(key, fn, arg):
        results[key] = round(timeit(fn, arg, k=k, repeats=repeats), 3)
        results[key.replace("_ms", "_device_ms")] = device_ms(dev, fn, arg)
        print(json.dumps(results), flush=True)

    timed("full_ms", lambda m: vocos.forward(params_c, m, cfg_c, dtype=bf16), mel)

    ws = [(blk["pw1"]["w"].to(bf16), blk["pw2"]["w"].to(bf16)) for blk in params_c["blocks"]]

    def mlps(x):
        h = x.reshape(b * t, cfg_c.vocos_dim)
        for w1, w2 in ws:
            h = F.gelu(h @ w1, approximate="tanh") @ w2
        return h

    timed("mlps_only_ms", mlps, x0)

    def vpu_real(x):
        h = x
        for blk in params_c["blocks"]:
            d = vocos._depthwise_conv(blk["dw"], blk["dw_b"], h, bf16)
            n = layers.layernorm(blk["ln"], d)
            h = h + n.to(bf16) * blk["gamma"].to(bf16)
        return h

    timed("vpu_only_ms", vpu_real, x0)

    def head(params, polar):
        def fn(x):
            h = layers.layernorm(params["ln_out"], x.float())
            hd = layers.dense(params["head"], h, bf16, tiled=True).float()
            mag = torch.exp(torch.clamp(hd[..., :n_bins], -14.0, 6.0))
            if polar:
                phase = hd[..., n_bins:]
                real, imag = mag * torch.cos(phase), mag * torch.sin(phase)
            else:
                xd, yd = hd[..., n_bins : 2 * n_bins], hd[..., 2 * n_bins :]
                inv = torch.rsqrt(xd * xd + yd * yd + 1e-12)
                real, imag = mag * xd * inv, mag * yd * inv
            return vocos.istft_synthesis(real, imag, cfg_c.n_fft, cfg_c.hop_length, tiled=True)
        return fn

    timed("head_istft_ms", head(params_p, polar=True), x0)
    timed("head_istft_cartesian_ms", head(params_c, polar=False), x0)
    timed("full_cartesian_ms", lambda m: vocos.forward(params_c, m, cfg_c, dtype=bf16), mel)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
