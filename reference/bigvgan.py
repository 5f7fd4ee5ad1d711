"""A plain float32 BigVGAN-v2 generator, the yardstick of `gonova_tts_tpu_torch.models.bigvgan`.

Written after the published code of NVIDIA's BigVGAN (Lee et al. 2022,
arXiv:2206.04658; github.com/NVIDIA/BigVGAN, `bigvgan.py` and
`alias_free_activation/torch/`) and its structure: `kaiser_sinc_filter1d`,
`UpSample1d`, `DownSample1d` (`LowPassFilter1d`), `SnakeBeta`, `Activation1d`,
`AMPBlock1` and the generator, in the published [B, C, T] layout, each conv one
`F.conv1d` / `F.conv_transpose1d`, TF32 off. It imports nothing of the port.

Where it departs from the published code:

  * weight norm is folded: each conv holds its plain weight;
  * the parameters are the port's tree (`vocoder/...`, JAX layouts): a conv weight
    `w` [k, C_in, C_out] is `Conv1d.weight` permuted; a transposed conv's `w` is a
    correlation kernel, so `ConvTranspose1d.weight` is `w` with its taps reversed;
  * `alpha` and `beta` are the log-scale parameters (`snake_logscale: true`);
  * the generator takes a mel [B, T, n_mels] and returns the waveform [B, T * hop]
    (the published one: [B, n_mels, T] → [B, 1, T * hop]);
  * only what `bigvgan_v2_24khz_100band_256x` uses: AMPBlock1, Snake-beta, no tanh
    and no bias at the last conv (the output clamped to [-1, 1]).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F


def sinc(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.tensor(1.0, device=x.device, dtype=x.dtype), torch.sin(math.pi * x) / math.pi / x)


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> torch.Tensor:
    """[1, 1, kernel_size]: a Kaiser-windowed sinc low-pass, scaled to sum 1."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    time = (torch.arange(-half_size, half_size) + 0.5) if even else (torch.arange(kernel_size) - half_size)
    filter_ = 2 * cutoff * window * sinc(2 * cutoff * time)
    filter_ /= filter_.sum()
    return filter_.view(1, 1, kernel_size)


class UpSample1d:
    def __init__(self, ratio: int = 2, kernel_size: int = 12, device=None):
        self.ratio, self.kernel_size, self.stride = ratio, kernel_size, ratio
        self.pad = kernel_size // ratio - 1
        self.pad_left = self.pad * self.stride + (kernel_size - self.stride) // 2
        self.pad_right = self.pad * self.stride + (kernel_size - self.stride + 1) // 2
        self.filter = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        x = F.pad(x, (self.pad, self.pad), mode="replicate")
        x = self.ratio * F.conv_transpose1d(x, self.filter.expand(c, -1, -1), stride=self.stride, groups=c)
        return x[..., self.pad_left : -self.pad_right]


class DownSample1d:
    """`LowPassFilter1d(cutoff 0.5 / ratio, half_width 0.6 / ratio, stride ratio)`."""

    def __init__(self, ratio: int = 2, kernel_size: int = 12, device=None):
        even = kernel_size % 2 == 0
        self.pad_left, self.pad_right = kernel_size // 2 - int(even), kernel_size // 2
        self.stride = ratio
        self.filter = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        x = F.pad(x, (self.pad_left, self.pad_right), mode="replicate")
        return F.conv1d(x, self.filter.expand(c, -1, -1), stride=self.stride, groups=c)


class SnakeBeta:
    """x + 1 / (beta + 1e-9) * sin(x * alpha)^2, alpha and beta per channel from their logs."""

    def __init__(self, p: Mapping):
        self.alpha, self.beta = p["alpha"], p["beta"]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.exp(self.alpha.unsqueeze(0).unsqueeze(-1))
        beta = torch.exp(self.beta.unsqueeze(0).unsqueeze(-1))
        return x + (1.0 / (beta + 1e-9)) * torch.pow(torch.sin(x * alpha), 2)


class Activation1d:
    def __init__(self, p: Mapping):
        device = p["alpha"].device
        self.upsample, self.act, self.downsample = UpSample1d(device=device), SnakeBeta(p), DownSample1d(device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.downsample(self.act(self.upsample(x)))


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return int((kernel_size * dilation - dilation) / 2)


def conv1d(p: Mapping, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    w = p["w"]
    b = p["b"] if "b" in p else None
    return F.conv1d(x, w.permute(2, 1, 0), b, dilation=dilation, padding=get_padding(w.shape[0], dilation))


def conv_transpose1d(p: Mapping, x: torch.Tensor, rate: int) -> torch.Tensor:
    w = p["w"]
    k = w.shape[0]
    return F.conv_transpose1d(x, w.flip(0).permute(1, 2, 0), p["b"], stride=rate, padding=(k - rate) // 2)


class AMPBlock1:
    def __init__(self, p: Mapping, acts: Mapping, dilations: Sequence[int]):
        self.p, self.dilations = p, dilations
        self.acts1 = [Activation1d(a) for a in acts["a1"]]
        self.acts2 = [Activation1d(a) for a in acts["a2"]]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2, a1, a2, d in zip(self.p["convs1"], self.p["convs2"], self.acts1, self.acts2, self.dilations):
            xt = a1(x)
            xt = conv1d(c1, xt, d)
            xt = a2(xt)
            xt = conv1d(c2, xt)
            x = xt + x
        return x


class BigVGAN:
    """The generator over the port's `vocoder` tree (nested dicts and lists of f32
    tensors); `rates` and `dilations` are the configuration's `upsample_rates` and
    `resblock_dilations`."""

    def __init__(self, p: Mapping, rates: Sequence[int], dilations: Sequence[Sequence[int]]):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p, self.rates = p, list(rates)
        self.resblocks = [[AMPBlock1(b, a, d) for b, a, d in zip(amps, acts, dilations)]
                          for amps, acts in zip(p["amps"], p["acts"])]
        self.activation_post = Activation1d(p["act_post"])

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        x = conv1d(self.p["conv_pre"], mel.transpose(1, 2))
        for up, blocks, rate in zip(self.p["ups"], self.resblocks, self.rates):
            x = conv_transpose1d(up, x, rate)
            xs = None
            for block in blocks:
                xs = block(x) if xs is None else xs + block(x)
            x = xs / len(blocks)
        x = self.activation_post(x)
        x = conv1d(self.p["conv_post"], x)
        return torch.clamp(x, min=-1.0, max=1.0)[:, 0]
