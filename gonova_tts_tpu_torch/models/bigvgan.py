"""BigVGAN-v2 generator (mel frames → waveform), in PyTorch.

NVIDIA's BigVGAN-v2 (Lee et al. 2022, arXiv:2206.04658; the configuration
`bigvgan_v2_24khz_100band_256x`), served as `vocoder_family="bigvgan"`. The JAX
package has no counterpart. Activations are [B, T, C]:

  * `conv_pre`: k=7 conv, n_mels → upsample_initial_channel;
  * per stage i: `ups[i]`, a transposed conv C → C/2 at rate u and kernel k (output
    length T * u; no activation before it, unlike HiFi-GAN), then the mean of the
    AMP blocks (AMPBlock1), one per resblock kernel: for each dilation d,
    `x = x + conv_k(act(conv_k,d(act(x))))`;
  * `act_post`, `conv_post` (k=7, C → 1, no bias), clamp to [-1, 1] (the v2
    configurations' `use_tanh_at_final: false`, `use_bias_at_final: false`).

`act` is the anti-aliased Snake-beta (`ops/snake_aa.py`: the CUDA kernel on a card,
its plain version on the CPU), with per-channel log-scale `alpha` and `beta`. Every
conv is `layers.conv1d` / `layers.conv1d_transpose` (cuDNN on the card), but for the
dilated AMP convs that `phase_split` picks (768, 384 and 192 channels with
(k - 1)·d >= 30, nine a forward at the published widths): they run as
`layers.conv1d_phased`, one undilated conv over the row's d phases, which cuDNN runs
on the tensor cores and not in its CUDA-core implicit GEMM. Weight norm is folded (a
plain `w`). The transposed convs' taps are stored as `layers` stores them, a
correlation kernel [k, C_in, C_out]: PyTorch's `ConvTranspose1d` weight is their
reverse. Between two convs the activations lie as [B, C, T] (what `conv1d` returns),
which the kernel reads and writes without a copy.

Tree: `conv_pre`, `ups[i]`, `amps[i][j]` (`convs1[d]`, `convs2[d]`), `acts[i][j]`
(`a1[d]`, `a2[d]`, each `{alpha, beta}`), `act_post`, `conv_post` (`w` alone).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import snake_aa
from ..utils import prof
from . import graphs, layers, vocoder
from .layers import Tree

CONV_STD = 0.01  # BigVGAN's init_weights: the transposed, AMP and last convs
LOG_SCALE_STD = 0.1  # log alpha and log beta of a fresh init (BigVGAN's: 0)


def _snake_init(g: torch.Generator, channels: int) -> Tree:
    return layers.leaf(alpha=layers._normal(g, (channels,), LOG_SCALE_STD),
                       beta=layers._normal(g, (channels,), LOG_SCALE_STD))


def _amp_init(g: torch.Generator, channels: int, kernel: int, dilations: Sequence[int]) -> Tree:
    return layers.group(
        convs1=nn.ModuleList(layers.conv1d_init(g, channels, channels, kernel, CONV_STD) for _ in dilations),
        convs2=nn.ModuleList(layers.conv1d_init(g, channels, channels, kernel, CONV_STD) for _ in dilations),
    )


def _acts_init(g: torch.Generator, channels: int, dilations: Sequence[int]) -> Tree:
    return layers.group(
        a1=nn.ModuleList(_snake_init(g, channels) for _ in dilations),
        a2=nn.ModuleList(_snake_init(g, channels) for _ in dilations),
    )


class Generator(Tree):
    """`{"conv_pre", "ups", "amps", "acts", "act_post", "conv_post"}`, seeded from `g`."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = layers.conv1d_init(g, cfg.n_mels, ch, 7)
        self.ups, self.amps, self.acts = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        for i, kernel in enumerate(cfg.upsample_kernels):
            cin, cout = ch // 2**i, ch // 2 ** (i + 1)
            self.ups.append(layers.conv1d_init(g, cin, cout, kernel, CONV_STD))
            pairs = list(zip(cfg.resblock_kernels, cfg.resblock_dilations))
            self.amps.append(nn.ModuleList(_amp_init(g, cout, rk, rd) for rk, rd in pairs))
            self.acts.append(nn.ModuleList(_acts_init(g, cout, rd) for _, rd in pairs))
        last = ch // 2 ** len(cfg.upsample_rates)
        self.act_post = _snake_init(g, last)
        self.conv_post = layers.leaf(w=layers._normal(g, (7, last, 1), CONV_STD))

    def forward(self, mel: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return forward(self, mel, self.cfg, dtype)


def init(g: torch.Generator, cfg: ModelConfig) -> Generator:
    return Generator(cfg, g)


def activations(cfg: ModelConfig) -> int:
    """Anti-aliased activations a forward runs (each one `snake_aa` launch on a card):
    two per dilation of every AMP block of every stage, and `act_post`."""
    return 2 * len(cfg.upsample_rates) * sum(len(rd) for rd in cfg.resblock_dilations) + 1


def reach_frames(cfg: ModelConfig) -> int:
    """Mel frames each side that one output sample can depend on (`vocoder.reach_frames`
    with the activation's 5 samples): 39 at the published widths."""
    return vocoder.reach_frames(cfg, snake_aa.REACH)


def forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype=torch.float32) -> torch.Tensor:
    """mel [B, T, n_mels] → waveform [B, T * prod(upsample_rates)], clamped, f32.
    Replayed from a CUDA graph where the serving pass has one (`graphs.run`)."""
    return graphs.run("bigvgan.forward", lambda: _forward(params, mel, cfg, dtype), params, (mel,), id(cfg), dtype)


def _act(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    alpha, inv_beta = layers.cached(p, ("snake_aa", x.device), lambda: snake_aa.constants(p["alpha"], p["beta"]))
    return snake_aa.snake_aa(x, alpha, inv_beta)


def phase_split(channels: int, kernel: int, dilation: int) -> bool:
    """Whether an AMP block runs its dilated conv as `layers.conv1d_phased`: where
    cuDNN, given the dilated conv, runs it as its CUDA-core implicit GEMM, and the
    undilated conv over the d phases on the tensor cores pays for the two copies
    (the per-conv table in PERF.md §6: B=16, 448 frames, bf16, H100)."""
    return channels >= 192 and (kernel - 1) * dilation >= 30


def phased_convs(cfg: ModelConfig) -> list:
    """(C, k, d) of each conv that a forward runs through the phase split."""
    chans = [cfg.upsample_initial_channel // 2 ** (i + 1) for i in range(len(cfg.upsample_rates))]
    return [(c, k, d) for c in chans for k, rd in zip(cfg.resblock_kernels, cfg.resblock_dilations) for d in rd
            if phase_split(c, k, d)]


def _amp_block(p: Mapping, acts: Mapping, x: torch.Tensor, dilations: Sequence[int], dtype) -> torch.Tensor:
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], acts["a1"], acts["a2"], dilations):
        a = _act(a1, x)
        if phase_split(x.shape[2], c1["w"].shape[0], d):
            xt = layers.conv1d_phased(c1, a, d, dtype)
        else:
            xt = layers.conv1d(c1, a, dilation=d, dtype=dtype)
        xt = layers.conv1d(c2, _act(a2, xt), dtype=dtype)
        x = xt + x
    return x


def _forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    x = layers.conv1d(params["conv_pre"], mel.to(dtype), dtype=dtype)
    for i, (up, amps, acts, rate) in enumerate(zip(params["ups"], params["amps"], params["acts"], cfg.upsample_rates)):
        with prof.stage(f"bigvgan.up{i}"):
            x = layers.conv1d_transpose(up, x, rate, dtype=dtype)
        with prof.stage(f"bigvgan.amp{i}"):
            acc = None
            for block, act, rd in zip(amps, acts, cfg.resblock_dilations):
                y = _amp_block(block, act, x, rd, dtype)
                acc = y if acc is None else acc + y
            x = acc / float(len(amps))
    x = _act(params["act_post"], x)
    x = layers._conv1d(params["conv_post"]["w"], x, 1, dtype, 1, 1)
    return torch.clamp(x[..., 0].float(), -1.0, 1.0)
