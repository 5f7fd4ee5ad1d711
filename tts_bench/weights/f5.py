"""`generate: {"kind": "f5"}`: F5-TTS v1's DiT (the `model` section's f5_* widths;
`models/f5.py`'s tree, the `acoustic` subtree) and Vocos at `n_mels` bands with a
polar head (the `vocoder` subtree) from the seed, on the device, in one draw, in
float16. Each leaf is N(mean, std²):

  * every Linear and conv weight and bias at PyTorch's default scale, the std of
    its uniform init, 1 / sqrt(3 fan_in) (fan_in per group for the grouped and
    depthwise convs); the text table N(0, 1) (nn.Embedding's); LayerNorms 1 and 0;
  * the adaLN Linears of every block and of `norm_out`, and `proj_out`, which F5's
    `initialize_weights` zeroes (an untrained model would compute the identity and
    serve the noise as its mel): drawn at that default scale like every other
    Linear, except `proj_out`'s bias, N(PROJ_OUT_MEAN, 0.5²) per band, which puts
    the sampled mel at a log-mel's level;
  * GRN's gamma and beta N(0, 0.1²) (F5 starts them at 0, where GRN is the identity);
  * Vocos (its `_init_weights`): the embed conv, the blocks' convs and Linears
    N(0, 0.02²), biases 0, layer scale 1 / layers, LayerNorms 1 and 0; the head's
    weight N(0, 0.02²), its log-magnitude bias HEAD_LOG_MAG and its phase bias
    N(0, π²), which make the waveform about as loud as speech (RMS ~0.1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

PROJ_OUT_MEAN = -5.0
TEXT_NUM_EMBEDS = 2545  # the published vocab.txt's symbols, plus the filler's row below
HEAD_LOG_MAG = 1.2


def _default(fan_in: int) -> float:
    return 1.0 / math.sqrt(3.0 * fan_in)


def _linear(path: str, n_in: int, n_out: int) -> List[Tuple[str, tuple, float, float]]:
    return [(f"{path}/w", (n_in, n_out), _default(n_in), 0.0), (f"{path}/b", (n_out,), _default(n_in), 0.0)]


def _ln(path: str, dim: int) -> List[Tuple[str, tuple, float, float]]:
    return [(f"{path}/g", (dim,), 0.0, 1.0), (f"{path}/b", (dim,), 0.0, 0.0)]


def dit_leaves(m: dict) -> List[Tuple[str, tuple, float, float]]:
    """(path, shape, std, mean) of every leaf of the DiT."""
    d, td, n_mels = m["f5_dim"], m["f5_text_dim"], m["n_mels"]
    ff = m["f5_ff_mult"] * d
    a = "acoustic"
    out = [(f"{a}/text_embed/table", (TEXT_NUM_EMBEDS + 1, td), 1.0, 0.0)]
    for i in range(m["f5_conv_layers"]):
        p = f"{a}/text_blocks/{i}"
        out += [(f"{p}/dw/w", (7, td), _default(7), 0.0), (f"{p}/dw/b", (td,), _default(7), 0.0)]
        out += _ln(f"{p}/ln", td) + _linear(f"{p}/pw1", td, 2 * td)
        out += [(f"{p}/grn/gamma", (2 * td,), 0.1, 0.0), (f"{p}/grn/beta", (2 * td,), 0.1, 0.0)]
        out += _linear(f"{p}/pw2", 2 * td, td)
    out += _linear(f"{a}/input_proj", 2 * n_mels + td, d)
    for j in range(2):
        fan = 31 * (d // 16)
        out += [(f"{a}/conv_pos/{j}/w", (31, d // 16, d), _default(fan), 0.0), (f"{a}/conv_pos/{j}/b", (d,), _default(fan), 0.0)]
    out += _linear(f"{a}/time_mlp/0", 256, d) + _linear(f"{a}/time_mlp/1", d, d)
    for i in range(m["f5_depth"]):
        p = f"{a}/blocks/{i}"
        out += _linear(f"{p}/ada", d, 6 * d)
        for n in "qkvo":
            out += _linear(f"{p}/attn/{n}", d, d)
        out += _linear(f"{p}/ff1", d, ff) + _linear(f"{p}/ff2", ff, d)
    out += _linear(f"{a}/norm_out", d, 2 * d)
    return out + [(f"{a}/proj_out/w", (d, n_mels), _default(d), 0.0), (f"{a}/proj_out/b", (n_mels,), 0.5, PROJ_OUT_MEAN)]


def vocos_leaves(m: dict) -> List[Tuple[str, tuple, float, float]]:
    c, f, n_mels = m["vocos_dim"], m["vocos_ff"], m["n_mels"]
    n_bins = m["n_fft"] // 2 + 1
    v = "vocoder"
    out = [(f"{v}/embed/w", (7, n_mels, c), 0.02, 0.0), (f"{v}/embed/b", (c,), 0.0, 0.0)]
    for i in range(m["vocos_layers"]):
        p = f"{v}/blocks/{i}"
        out += [(f"{p}/dw", (7, c), 0.02, 0.0), (f"{p}/dw_b", (c,), 0.0, 0.0), (f"{p}/gamma", (c,), 0.0, 1.0 / m["vocos_layers"])]
        out += _ln(f"{p}/ln", c)
        out += [(f"{p}/pw1/w", (c, f), 0.02, 0.0), (f"{p}/pw1/b", (f,), 0.0, 0.0),
                (f"{p}/pw2/w", (f, c), 0.02, 0.0), (f"{p}/pw2/b", (c,), 0.0, 0.0)]
    out += _ln(f"{v}/ln_out", c)
    return out + [(f"{v}/head/w", (c, 2 * n_bins), 0.02, 0.0), (f"{v}/head/b_mag", (n_bins,), 0.0, HEAD_LOG_MAG),
                  (f"{v}/head/b_phase", (n_bins,), math.pi, 0.0)]


def dit_params(m: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in dit_leaves(m))


def make(m: dict, seed: int, device) -> Dict[str, np.ndarray]:
    tree = dit_leaves(m) + vocos_leaves(m)
    sizes = [math.prod(shape) for _, shape, _, _ in tree]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat *= torch.cat([torch.full((n,), s, device=device) for n, (_, _, s, _) in zip(sizes, tree)])
    flat += torch.cat([torch.full((n,), mu, device=device) for n, (_, _, _, mu) in zip(sizes, tree)])
    host = flat.to(torch.float16).cpu().numpy()
    out, at = {}, 0
    for n, (path, shape, _, _) in zip(sizes, tree):
        out[path] = host[at : at + n].reshape(shape)
        at += n
    head = "vocoder/head"
    out[f"{head}/b"] = np.concatenate([out.pop(f"{head}/b_mag"), out.pop(f"{head}/b_phase")])
    return out
