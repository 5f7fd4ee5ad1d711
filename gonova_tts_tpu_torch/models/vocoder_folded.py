"""Lane-folded NovaGAN generator, in PyTorch.

Counterpart of `gonova_tts_tpu/models/vocoder_folded.py`, computed the same way.
The JAX package shaped this layout for the TPU's 128-lane matrix tile: the
generator's late stages run convs at C = 16..64 channels over long sequences, so
time is folded into channels. A signal x[t, c] at rate T with C channels is stored
as X[u, r·C + c] with t = u·f + r and fold factor f = 128 // C. A SAME conv (kernel
k, dilation d) becomes a conv over folded steps whose weight
W_f[tap, r_in·C + ci, r_out·C + co] scatters the original w[j, ci, co] by

    q = r_out + offset_j,   tap = floor(q / f) - lo,   r_in = q mod f,

a banded block matrix stored dense. Transposed convs zero-stuff in folded space (a
reshape and a pad: the stuffed signal at rate T·s is the fold-(f·s) layout) and run
the same folded conv with offsets j - (k-1-p), as `layers.conv1d_transpose` (no
kernel flip). Changing the fold at one rate is a reshape.

The same sums as `vocoder.forward`, reorganized, plus exact zeros: equal to it at
f32 rounding level (rtol 1e-5 / atol 2e-5, as the JAX package pins its own fold).
Differentiable; `hifigan_folded` (on by default) routes serving and training
through it, as in the JAX package. Whether the fold helps cuDNN on an H100 is a
measurement (`chip_smoke.py`), not an assumption of this module.
"""

from __future__ import annotations

import functools
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from . import graphs, layers, vocoder

LRELU_SLOPE = vocoder.LRELU_SLOPE

# The TPU matrix unit's lane width, the tile this layout was shaped for; the fold
# keeps it so that both packages compute the same sums in the same layout.
MXU_LANES = 128


def _target_fold(channels: int) -> int:
    """Fold factor that brings a C-channel tensor to (at least) 128 lanes."""
    return max(1, MXU_LANES // channels)


@functools.lru_cache(maxsize=None)
def _fold_selector(k: int, f_in: int, f_out: int, offsets: Tuple[int, ...]) -> Tuple[np.ndarray, int]:
    """Static scatter map for folding a conv weight: S [k, K_f, f_in, f_out] with
    S[j, tap, r_in, r_out] = 1 where original tap j connects input sub-position r_in
    to output sub-position r_out through folded tap `tap`, and `lo`, the most
    negative folded-step offset."""
    lo = min((r + o) // f_in for r in range(f_out) for o in offsets)
    hi = max((r + o) // f_in for r in range(f_out) for o in offsets)
    k_f = hi - lo + 1
    sel = np.zeros((k, k_f, f_in, f_out), dtype=np.float32)
    for r_out in range(f_out):
        for j, o in enumerate(offsets):
            q = r_out + o
            sel[j, q // f_in - lo, q % f_in, r_out] = 1.0
    return sel, lo


@functools.lru_cache(maxsize=None)
def _selector_on(k: int, f_in: int, f_out: int, offsets: Tuple[int, ...], dtype, device) -> Tuple[torch.Tensor, int]:
    """`_fold_selector` as a tensor on `device`, copied there once (not per conv call).
    Made outside inference mode whatever the caller's mode: serving may build it
    first, and an inference tensor cannot enter a later training step's graph."""
    sel, lo = _fold_selector(k, f_in, f_out, offsets)
    with torch.inference_mode(False):
        return torch.as_tensor(sel, dtype=dtype, device=device), lo


def _fold_weight(w: torch.Tensor, f_in: int, f_out: int, offsets: Sequence[int]) -> Tuple[torch.Tensor, int]:
    """w [k, Cin, Cout] → W_f [K_f, f_in·Cin, f_out·Cout] (dense banded block matrix)."""
    k, cin, cout = w.shape
    sel, lo = _selector_on(k, f_in, f_out, tuple(offsets), w.dtype, w.device)
    wf = torch.einsum("jtqr,jio->tqiro", sel, w)
    return wf.reshape(sel.shape[1], f_in * cin, f_out * cout), lo


def _folded_conv(
    x: torch.Tensor,  # [B, U, f_in·Cin]
    wf: torch.Tensor,  # [K_f, f_in·Cin, f_out·Cout]
    bias: torch.Tensor,  # [Cout]
    f_out: int,
    lo: int,
    stride: int,
    dtype,
) -> torch.Tensor:
    """Correlation over folded steps with padding (-lo, hi); a negative pad crops."""
    hi = lo + wf.shape[0] - 1
    xt = F.pad(x.to(dtype).transpose(1, 2), (-lo, hi))
    y = F.conv1d(xt, wf.to(dtype).permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + bias.to(dtype).repeat(f_out)


def _conv_same(p: Mapping, x: torch.Tensor, f: int, dilation: int, dtype) -> torch.Tensor:
    """SAME conv on a fold-f tensor; the plain conv when f == 1."""
    if f == 1:
        return layers.conv1d(p, x, dilation=dilation, dtype=dtype)
    k = p["w"].shape[0]
    # XLA's SAME pads ((k-1)*d) // 2 on the left; the offsets follow from that
    # (for an even k it is not (k//2 - 1) * d).
    pad_low = ((k - 1) * dilation) // 2
    offsets = [j * dilation - pad_low for j in range(k)]
    wf, lo = _fold_weight(p["w"], f, f, offsets)
    return _folded_conv(x, wf, p["b"], f, lo, 1, dtype)


def _refold(x: torch.Tensor, f_from: int, channels: int, f_to: int) -> torch.Tensor:
    """[B, U, f_from·C] → [B, U', f_to·C] at the same audio rate (reshapes only)."""
    if f_from == f_to:
        return x
    b, u, _ = x.shape
    t = u * f_from
    return x.reshape(b, t, channels).reshape(b, t // f_to, f_to * channels)


def _resblock_folded(p: Mapping, x: torch.Tensor, dilations: Sequence[int], f: int, dtype) -> torch.Tensor:
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        h = layers.leaky_relu(x, LRELU_SLOPE)
        h = _conv_same(c1, h, f, d, dtype)
        h = layers.leaky_relu(h, LRELU_SLOPE)
        h = _conv_same(c2, h, f, 1, dtype)
        x = x + h
    return x


def forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype=torch.float32) -> torch.Tensor:
    """mel [B, T, n_mels] → waveform [B, T · prod(upsample_rates)], f32.

    The parameters and the result of `vocoder.forward`; only the layout differs.
    A stage whose length does not divide by its fold stays at the fold it has.
    Replayed from a CUDA graph where the serving pass has one (`graphs.run`)."""
    return graphs.run(
        "vocoder_folded.forward", lambda: _forward(params, mel, cfg, dtype), params, (mel,), id(cfg), dtype
    )


def _forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    b = mel.shape[0]
    x = layers.conv1d(params["conv_pre"], mel.to(dtype), dtype=dtype)
    ch = cfg.upsample_initial_channel
    f = 1  # current fold; x is [B, T/f, f·C]
    t = mel.shape[1]
    for i, (rate, kernel) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        c_in, c_out = ch // (2**i), ch // (2 ** (i + 1))
        x = layers.leaky_relu(x, LRELU_SLOPE)
        up = params["ups"][i]
        if f == 1 and c_out >= MXU_LANES // 2:
            # Wide enough: the plain transposed conv.
            x = layers.conv1d_transpose(up, x, rate, dtype=dtype)
        else:
            # Zero-stuff in folded space: [B, U, f, 1, C] → [B, U, f, rate, C]; the
            # stuffed rate-T·s signal is the fold-(f·rate) layout.
            u = x.shape[1]
            x = F.pad(x.reshape(b, u, f, 1, c_in), (0, 0, 0, rate - 1)).reshape(b, u, f * rate * c_in)
            pad = (kernel - rate) // 2
            offsets = [j - (kernel - 1 - pad) for j in range(kernel)]
            f *= rate
            wf, lo = _fold_weight(up["w"], f, f, offsets)
            x = _folded_conv(x, wf, up["b"], f, lo, 1, dtype)
        t *= rate
        f_t = _target_fold(c_out) if t % _target_fold(c_out) == 0 else f
        x = _refold(x, f, c_out, f_t)
        f = f_t
        acc = None
        for block, rd in zip(params["mrfs"][i], cfg.resblock_dilations):
            y = _resblock_folded(block, x, rd, f, dtype)
            acc = y if acc is None else acc + y
        x = acc / float(len(params["mrfs"][i]))
    x = layers.leaky_relu(x, LRELU_SLOPE)
    post = params["conv_post"]
    k_post = post["w"].shape[0]
    if t % MXU_LANES == 0 and MXU_LANES % f == 0:
        # Fold the 1-channel output to 128 lanes: a strided folded conv.
        offsets = [j - (k_post - 1) // 2 for j in range(k_post)]
        wf, lo = _fold_weight(post["w"], f, MXU_LANES, offsets)
        x = _folded_conv(x, wf, post["b"], MXU_LANES, lo, MXU_LANES // f, dtype)
        wav = x.reshape(b, t)
    else:
        x = _refold(x, f, ch // (2 ** len(cfg.upsample_rates)), 1)
        wav = layers.conv1d(post, x, dtype=dtype)[..., 0]
    return torch.tanh(wav.float())
