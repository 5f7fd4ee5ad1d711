"""`generate: {"kind": "hifigan"}`: a HiFi-GAN generator (the `model` section's widths, rates and
kernels) from the seed, on the device, in one draw: the transposed and the MRF convs
N(0, 0.01) (jik876/hifi-gan's `init_weights`), the first and last convs
N(0, 2 / (k * C_in + C_out)), biases 0, as the `vocoder` subtree in float16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def leaves(m: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, std) of every weight of the generator; std 0 marks a bias."""
    ch = m["upsample_initial_channel"]
    out = [("conv_pre/w", (7, m["n_mels"], ch), math.sqrt(2.0 / (7 * m["n_mels"] + ch))), ("conv_pre/b", (ch,), 0.0)]
    for i, k in enumerate(m["upsample_kernels"]):
        cin, cout = ch // 2**i, ch // 2 ** (i + 1)
        out += [(f"ups/{i}/w", (k, cin, cout), 0.01), (f"ups/{i}/b", (cout,), 0.0)]
        for j, (rk, rd) in enumerate(zip(m["resblock_kernels"], m["resblock_dilations"])):
            for half in ("convs1", "convs2"):
                for d in range(len(rd)):
                    out += [(f"mrfs/{i}/{j}/{half}/{d}/w", (rk, cout, cout), 0.01),
                            (f"mrfs/{i}/{j}/{half}/{d}/b", (cout,), 0.0)]
    last = ch // 2 ** len(m["upsample_rates"])
    out += [("conv_post/w", (7, last, 1), math.sqrt(2.0 / (7 * last + 1))), ("conv_post/b", (1,), 0.0)]
    return out


def make(m: dict, seed: int, device) -> Dict[str, np.ndarray]:
    tree = leaves(m)
    sizes = [math.prod(shape) for _, shape, _ in tree]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    std = torch.cat([torch.full((n,), s, device=device) for n, (_, _, s) in zip(sizes, tree)])
    host = (flat * std).to(torch.float16).cpu().numpy()
    out, at = {}, 0
    for n, (path, shape, _) in zip(sizes, tree):
        out[f"vocoder/{path}"] = host[at : at + n].reshape(shape)
        at += n
    return out
