"""`generate: {"kind": "bigvgan"}`: a BigVGAN-v2 generator (the `model` section's
widths, rates, kernels and dilations; `models/bigvgan.py`'s tree) and a mel head of
`n_mels` bands for the kept acoustic model, from the seed, on the device, in one draw,
as the `vocoder` subtree and `acoustic/mel_out` in float16:

  * the AMP and last convs N(0, 0.01) (BigVGAN's `init_weights`); the last conv has no
    bias;
  * the transposed convs N(0, 1 / (k / rate * C_in)), which keeps the
    waveform's level through each stage, where BigVGAN's N(0, 0.01) divides it by 2 to
    10 a stage: with it an untrained generator speaks at ~1e-4 (3 PCM16 steps), and the
    comparison that decides `correct` would read the PCM16 rounding (a trained
    generator, whose weight norms learn the level, speaks at ~0.1, as this one does);
  * the first conv's weight and every conv's bias N(0, 1 / (3 fan_in)), the variance
    of PyTorch's default init of a conv, which `init_weights` leaves to them;
  * each activation's log alpha and log beta N(0, 0.1^2) per channel (BigVGAN starts
    them at 0; drawn here so that a kernel that mixes up channels gives other audio);
  * `acoustic/mel_out` d_model → n_mels, Xavier-normal as the acoustic model's dense
    layers start, bias 0: it replaces the kept checkpoint's head of another width.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def leaves(m: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, std) of every made leaf; std 0 marks a zero bias."""
    ch, n_mels = m["upsample_initial_channel"], m["n_mels"]
    default = lambda fan_in: 1.0 / math.sqrt(3.0 * fan_in)  # noqa: E731
    out = [("vocoder/conv_pre/w", (7, n_mels, ch), default(7 * n_mels)), ("vocoder/conv_pre/b", (ch,), default(7 * n_mels))]
    for i, k in enumerate(m["upsample_kernels"]):
        cin, cout = ch // 2**i, ch // 2 ** (i + 1)
        out += [(f"vocoder/ups/{i}/w", (k, cin, cout), 1.0 / math.sqrt(k // m["upsample_rates"][i] * cin)),
                (f"vocoder/ups/{i}/b", (cout,), default(k * cout))]
        for j, (rk, rd) in enumerate(zip(m["resblock_kernels"], m["resblock_dilations"])):
            for half in ("convs1", "convs2"):
                for d in range(len(rd)):
                    out += [(f"vocoder/amps/{i}/{j}/{half}/{d}/w", (rk, cout, cout), 0.01),
                            (f"vocoder/amps/{i}/{j}/{half}/{d}/b", (cout,), default(rk * cout))]
            for half in ("a1", "a2"):
                for d in range(len(rd)):
                    out += [(f"vocoder/acts/{i}/{j}/{half}/{d}/alpha", (cout,), 0.1),
                            (f"vocoder/acts/{i}/{j}/{half}/{d}/beta", (cout,), 0.1)]
    last = ch // 2 ** len(m["upsample_rates"])
    out += [("vocoder/act_post/alpha", (last,), 0.1), ("vocoder/act_post/beta", (last,), 0.1),
            ("vocoder/conv_post/w", (7, last, 1), 0.01)]
    d = m["d_model"]
    return out + [("acoustic/mel_out/w", (d, n_mels), math.sqrt(2.0 / (d + n_mels))), ("acoustic/mel_out/b", (n_mels,), 0.0)]


def make(m: dict, seed: int, device) -> Dict[str, np.ndarray]:
    tree = leaves(m)
    sizes = [math.prod(shape) for _, shape, _ in tree]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat *= torch.cat([torch.full((n,), s, device=device) for n, (_, _, s) in zip(sizes, tree)])
    host = flat.to(torch.float16).cpu().numpy()
    out, at = {}, 0
    for n, (path, shape, _) in zip(sizes, tree):
        out[path] = host[at : at + n].reshape(shape)
        at += n
    return out
