"""NovaGAN — HiFi-GAN-class vocoder generator (mel frames → waveform), in PyTorch.

Counterpart of `gonova_tts_tpu/models/vocoder.py`: transposed-conv upsampling
(×8·8·2·2 = 256 = hop length) with multi-receptive-field (MRF) residual stacks, per
the HiFi-GAN paper (arxiv 2010.05646). Activations are [B, T, C]; every conv is
`layers.conv1d` / `layers.conv1d_transpose` (cuDNN on the card). The JAX package
has no Pallas kernel for this family, so neither has the port.

Also the discriminators the adversarial training phase uses: multi-period (MPD)
and multi-scale (MSD), the paper's topology (strided and grouped convs).

Parameter names follow the JAX tree: `Generator` holds `conv_pre`, `ups` (a list),
`mrfs` (a list of lists of `{convs1, convs2}`) and `conv_post`, so a state_dict key
is the JAX '/' path with dots.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from . import graphs, layers
from .layers import Tree

LRELU_SLOPE = 0.1


# ---------------------------------------------------------------- generator


def _resblock_init(g: torch.Generator, channels: int, kernel: int, dilations: Sequence[int]) -> Tree:
    return layers.group(
        convs1=nn.ModuleList(layers.conv1d_init(g, channels, channels, kernel) for _ in dilations),
        convs2=nn.ModuleList(layers.conv1d_init(g, channels, channels, kernel) for _ in dilations),
    )


def _resblock_apply(p: Mapping, x: torch.Tensor, dilations: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        h = layers.leaky_relu(x, LRELU_SLOPE)
        h = layers.conv1d(c1, h, dilation=d, dtype=dtype)
        h = layers.leaky_relu(h, LRELU_SLOPE)
        h = layers.conv1d(c2, h, dtype=dtype)
        x = x + h
    return x


class Generator(Tree):
    """`{"conv_pre", "ups", "mrfs", "conv_post"}`, seeded from `g`."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = layers.conv1d_init(g, cfg.n_mels, ch, 7)
        self.ups = nn.ModuleList()
        self.mrfs = nn.ModuleList()
        for i, kernel in enumerate(cfg.upsample_kernels):
            in_ch, out_ch = ch // (2**i), ch // (2 ** (i + 1))
            self.ups.append(layers.conv1d_init(g, in_ch, out_ch, kernel))
            self.mrfs.append(nn.ModuleList(
                _resblock_init(g, out_ch, rk, rd)
                for rk, rd in zip(cfg.resblock_kernels, cfg.resblock_dilations)
            ))
        self.conv_post = layers.conv1d_init(g, ch // (2 ** len(cfg.upsample_rates)), 1, 7)

    def forward(self, mel: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return forward(self, mel, self.cfg, dtype)


def init(g: torch.Generator, cfg: ModelConfig) -> Generator:
    return Generator(cfg, g)


def forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype=torch.float32) -> torch.Tensor:
    """mel [B, T, n_mels] → waveform [B, T * prod(upsample_rates)], tanh, f32.
    Replayed from a CUDA graph where the serving pass has one (`graphs.run`)."""
    return graphs.run("vocoder.forward", lambda: _forward(params, mel, cfg, dtype), params, (mel,), id(cfg), dtype)


def _forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    x = layers.conv1d(params["conv_pre"], mel.to(dtype), dtype=dtype)
    for up, mrf, rate in zip(params["ups"], params["mrfs"], cfg.upsample_rates):
        x = layers.leaky_relu(x, LRELU_SLOPE)
        x = layers.conv1d_transpose(up, x, rate, dtype=dtype)
        acc = None
        for block, rd in zip(mrf, cfg.resblock_dilations):
            y = _resblock_apply(block, x, rd, dtype=dtype)
            acc = y if acc is None else acc + y
        x = acc / float(len(mrf))
    x = layers.leaky_relu(x, LRELU_SLOPE)
    x = layers.conv1d(params["conv_post"], x, dtype=dtype)
    return torch.tanh(x[..., 0].float())


def upsample_factor(cfg: ModelConfig) -> int:
    f = 1
    for r in cfg.upsample_rates:
        f *= r
    return f


def reach_frames(cfg: ModelConfig, act_reach: int = 0) -> int:
    """Mel frames on each side that one output sample can depend on, for this
    generator's layout (conv_pre, per stage a transposed conv and the mean of the
    residual blocks, conv_post): each layer's one-sided reach in the samples it reads,
    over the samples a mel frame has there, summed and rounded up. `act_reach`: the
    samples each side one activation reads (0 for a pointwise one; BigVGAN's
    anti-aliased Snake-beta reads 5). HiFi-GAN V1 at 24 kHz: 14; BigVGAN-v2: 39."""
    reach, per = 7 // 2, 1  # conv_pre, k=7, at one sample a frame
    for rate, kernel in zip(cfg.upsample_rates, cfg.upsample_kernels):
        # An output n of the transposed conv (padding (k - u) // 2) reads inputs
        # (n + pad - j) / u, j < k: at most (k - 1 - pad) / u from n / u.
        reach += (kernel - 1 - (kernel - rate) // 2) / rate / per
        per *= rate
        reach += max(sum(2 * act_reach + k // 2 * (d + 1) for d in dils)
                     for k, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations)) / per
    return math.ceil(reach + (act_reach + 7 // 2) / per)  # the last activation and conv_post


# ---------------------------------------------------------------- discriminators
# (training only; topology per the HiFi-GAN paper §2.3)

_MPD_PERIODS = (2, 3, 5, 7, 11)


def _width_fn(width: float):
    """Channel scaler for the discriminator width knob: multiples of 16 (grouped
    convs need divisibility), floor 16."""

    def w(c: int) -> int:
        return max(16, int(round(c * width / 16.0)) * 16)

    return w


def mpd_init(g: torch.Generator, width: float = 1.0) -> Tree:
    """Multi-period discriminator: per period five k=5 conv levels (1→32→128→512→
    1024 at stride 3, then 1024→1024 at stride 1) and a k=3 post conv. `width`
    scales every channel count (1.0 = the paper's capacity)."""
    w = _width_fn(width)
    chans = [(1, w(32)), (w(32), w(128)), (w(128), w(512)), (w(512), w(1024)), (w(1024), w(1024))]
    subs = nn.ModuleList(
        layers.group(
            convs=nn.ModuleList(layers.conv1d_init(g, cin, cout, 5) for cin, cout in chans),
            conv_post=layers.conv1d_init(g, w(1024), 1, 3),
        )
        for _ in _MPD_PERIODS
    )
    return layers.group(subs=subs)


def _mpd_sub_apply(p: Mapping, x2d: torch.Tensor, dtype=torch.float32) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x2d: [B, T//period, period], run as [B*period, T//period, 1]."""
    b, t, period = x2d.shape
    h = x2d.transpose(1, 2).reshape(b * period, t, 1)
    feats = []
    convs = p["convs"]
    for j, c in enumerate(convs):
        h = layers.conv1d(c, h, stride=3 if j < len(convs) - 1 else 1, dtype=dtype)
        h = layers.leaky_relu(h, LRELU_SLOPE)
        feats.append(h)
    out = layers.conv1d(p["conv_post"], h, dtype=dtype)
    feats.append(out)
    return out.reshape(b, -1), feats


def mpd_apply(p: Mapping, wav: torch.Tensor, dtype=torch.float32):
    """wav [B, T] → per period (logits [B, N], feature list)."""
    b, t = wav.shape
    outs = []
    for sub, period in zip(p["subs"], _MPD_PERIODS):
        t_pad = -(-t // period) * period
        x = F.pad(wav[:, None], (0, t_pad - t), mode="reflect")[:, 0] if t_pad > t else wav
        outs.append(_mpd_sub_apply(sub, x.reshape(b, t_pad // period, period), dtype))
    return outs


# The paper's (MelGAN-derived) DiscriminatorS: (in, out, kernel, stride, groups).
_MSD_SCHEDULE = (
    (1, 128, 15, 1, 1),
    (128, 128, 41, 2, 4),
    (128, 256, 41, 2, 16),
    (256, 512, 41, 4, 16),
    (512, 1024, 41, 4, 16),
    (1024, 1024, 41, 1, 16),
    (1024, 1024, 5, 1, 1),
)


def msd_init(g: torch.Generator, width: float = 1.0) -> Tree:
    """Multi-scale discriminator on 1x, 2x and 4x average-pooled audio: the grouped
    schedule `_MSD_SCHEDULE` per scale (group counts fixed; `width` scales channels)."""
    w = _width_fn(width)
    subs = nn.ModuleList(
        layers.group(
            convs=nn.ModuleList(
                layers.conv1d_init(g, cin if cin == 1 else w(cin), w(cout), k, groups=grp)
                for cin, cout, k, _s, grp in _MSD_SCHEDULE
            ),
            conv_post=layers.conv1d_init(g, w(1024), 1, 3),
        )
        for _ in range(3)
    )
    return layers.group(subs=subs)


def _avg_pool1d(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """AvgPool1d(k, stride, pad) with count_include_pad=True over [B, T]."""
    return F.avg_pool1d(x[:, None], k, stride, pad, count_include_pad=True)[:, 0]


def msd_apply(p: Mapping, wav: torch.Tensor, dtype=torch.float32):
    outs = []
    x = wav
    for i, sub in enumerate(p["subs"]):
        if i > 0:
            x = _avg_pool1d(x, 4, 2, 2)
        h = x[..., None]
        feats = []
        for c, (_ci, _co, _k, stride, groups) in zip(sub["convs"], _MSD_SCHEDULE):
            h = layers.conv1d(c, h, stride=stride, dtype=dtype, groups=groups)
            h = layers.leaky_relu(h, LRELU_SLOPE)
            feats.append(h)
        out = layers.conv1d(sub["conv_post"], h, dtype=dtype)
        feats.append(out)
        outs.append((out.reshape(out.shape[0], -1), feats))
    return outs


def discriminators_init(g_mpd: torch.Generator, g_msd: torch.Generator, width: float = 1.0) -> Tree:
    """`{"mpd", "msd"}`: the adversarial phase's critics."""
    return layers.group(mpd=mpd_init(g_mpd, width), msd=msd_init(g_msd, width))
