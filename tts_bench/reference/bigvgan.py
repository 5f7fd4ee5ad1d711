"""The plain float32 reference of the bigvgan family: BigVGAN-v2's generator
(arXiv:2206.04658, NVIDIA's `bigvgan_v2_24khz_100band_256x`) in place of model.py's
vocoder, behind model.py's acoustic model (its 100-band head) and its speaker encoder
at the voice path's own mel (`speaker_n_mels` bands).

The generator follows the published code's structure (`Activation1d(UpSample1d,
SnakeBeta, DownSample1d)`, `AMPBlock1`, the generator), in its [B, C, T] layout, as
the repository's `reference/bigvgan.py` does line for line; the one addition is
`Numerics`, which rounds the operands of every conv of the model (not the fixed
resampling filters) for the float8 control. Departures from the published code: weight
norm folded; the served tree's layouts (a conv's `w` [k, C_in, C_out]; a transposed
conv's `w` a correlation kernel, so `ConvTranspose1d.weight` is `w` with its taps
reversed); log-scale `alpha` and `beta`; mel [B, T, n_mels] in, waveform [B, T * hop]
out, clamped to [-1, 1] (no tanh, no bias at the last conv). It imports nothing of
the served program.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import model
from .model import FP32, Numerics


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


def conv1d(p: Mapping, x: torch.Tensor, num: Numerics, dilation: int = 1) -> torch.Tensor:
    w = p["w"]
    b = p["b"] if "b" in p else None
    return F.conv1d(num.q(x), num.q(w).permute(2, 1, 0), b, dilation=dilation, padding=get_padding(w.shape[0], dilation))


def conv_transpose1d(p: Mapping, x: torch.Tensor, rate: int, num: Numerics) -> torch.Tensor:
    w = p["w"]
    k = w.shape[0]
    return F.conv_transpose1d(num.q(x), num.q(w).flip(0).permute(1, 2, 0), p["b"], stride=rate, padding=(k - rate) // 2)


class AMPBlock1:
    def __init__(self, p: Mapping, acts: Mapping, dilations: Sequence[int], num: Numerics):
        self.p, self.dilations, self.num = p, dilations, num
        self.acts1 = [Activation1d(a) for a in acts["a1"]]
        self.acts2 = [Activation1d(a) for a in acts["a2"]]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2, a1, a2, d in zip(self.p["convs1"], self.p["convs2"], self.acts1, self.acts2, self.dilations):
            xt = a1(x)
            xt = conv1d(c1, xt, self.num, d)
            xt = a2(xt)
            xt = conv1d(c2, xt, self.num)
            x = xt + x
        return x


class BigVGAN:
    """The generator over the served `vocoder` tree (nested dicts and lists of f32
    tensors); `rates` and `dilations` are the configuration's `upsample_rates` and
    `resblock_dilations`."""

    def __init__(self, p: Mapping, rates: Sequence[int], dilations: Sequence[Sequence[int]], num: Numerics = FP32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p, self.rates, self.num = p, list(rates), num
        self.resblocks = [[AMPBlock1(b, a, d, num) for b, a, d in zip(amps, acts, dilations)]
                          for amps, acts in zip(p["amps"], p["acts"])]
        self.activation_post = Activation1d(p["act_post"])

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        x = conv1d(self.p["conv_pre"], mel.transpose(1, 2), self.num)
        for up, blocks, rate in zip(self.p["ups"], self.resblocks, self.rates):
            x = conv_transpose1d(up, x, rate, self.num)
            xs = None
            for block in blocks:
                xs = block(x) if xs is None else xs + block(x)
            x = xs / len(blocks)
        x = self.activation_post(x)
        x = conv1d(self.p["conv_post"], x, self.num)
        return torch.clamp(x, min=-1.0, max=1.0)[:, 0]


class Reference(model.Reference):
    """model.Reference with the BigVGAN generator as its vocoder (the sentence's mel
    followed by 64 zero frames, as model.py's vocoders see it) and its speaker path at
    `speaker_n_mels` bands (None: `n_mels`)."""

    def __init__(self, tree: Dict, settings: Dict, device, num: Numerics = FP32):
        super().__init__(tree, settings, device, num)
        self.generator = BigVGAN(tree["vocoder"], settings["upsample_rates"], settings["resblock_dilations"], num)
        voice = dict(settings, n_mels=settings.get("speaker_n_mels") or settings["n_mels"])
        self.voice = model.Reference(tree, voice, device, num)

    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        t = mel.shape[0]
        return self.generator(F.pad(mel, (0, 0, 0, 64))[None])[0, : t * self.s["hop_length"]]

    def embed(self, wav: np.ndarray, sr: int) -> np.ndarray:
        return self.voice.embed(wav, sr)
