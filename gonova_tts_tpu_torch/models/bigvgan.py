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
activation lies as [B, T, C] contiguous from `conv_pre` to `conv_post` (channels-last):
each conv runs on `layers`' channels-last path (`conv1d_nwc`, `conv1d_transpose_nwc`,
its weight cast and laid out once as cuDNN's channels-last filter), so cuDNN runs its
NHWC tensor-core kernels with no layout conversion at either end, and the activation
kernel reads and writes the same layout. The dilated AMP convs that `phase_split`
picks (768, 384 and 192 channels with (k - 1)·d >= 30, nine a forward at the
published widths) run as `layers.conv1d_phased`, one undilated conv over the row's d
phases, which cuDNN runs on the tensor cores (given them dilated, it runs a CUDA-core
kernel). Weight norm is folded (a plain `w`). The transposed convs' taps are stored
as `layers` stores them, a correlation kernel [k, C_in, C_out]: PyTorch's
`ConvTranspose1d` weight is their reverse.

Biases are added where a read already happens: the first conv of each AMP pair
leaves its bias to the activation after it, which adds it as it loads; the
transposed conv and each pair's second conv leave theirs in an offset that the
stage's residual streams carry (`_offsets`), which each first activation adds as it
loads and the mean of the AMP blocks adds once. So the only passes over an
activation besides the convs and the activations are the residual sums and the mean.

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


def convs(cfg: ModelConfig) -> int:
    """Convs a forward runs (each one `conv_nwc` count): `conv_pre`, the transposed
    convs, two per dilation of every AMP block of every stage, `conv_post`; 116 at the
    published widths."""
    return 2 + len(cfg.upsample_rates) * (1 + 2 * sum(len(rd) for rd in cfg.resblock_dilations))


def reach_frames(cfg: ModelConfig) -> int:
    """Mel frames each side that one output sample can depend on (`vocoder.reach_frames`
    with the activation's 5 samples): 39 at the published widths."""
    return vocoder.reach_frames(cfg, snake_aa.REACH)


def forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype=torch.float32) -> torch.Tensor:
    """mel [B, T, n_mels] → waveform [B, T * prod(upsample_rates)], clamped, f32.
    Replayed from a CUDA graph where the serving pass has one (`graphs.run`)."""
    return graphs.run("bigvgan.forward", lambda: _forward(params, mel, cfg, dtype), params, (mel,), id(cfg), dtype)


def _act(p: Mapping, x: torch.Tensor, bias=None) -> torch.Tensor:
    alpha, inv_beta = layers.cached_frozen(p, ("snake_aa", x.device), lambda: snake_aa.constants(p["alpha"], p["beta"]))
    return snake_aa.snake_aa(x, alpha, inv_beta, bias)


def phase_split(channels: int, kernel: int, dilation: int) -> bool:
    """Whether an AMP block runs its dilated conv as `layers.conv1d_phased`: where
    cuDNN, given the dilated conv, runs it in a CUDA-core kernel (channels-last: a
    direct grouped conv, 35-755 ms a call at B=16, 448 frames), and the undilated conv
    over the d phases on the tensor cores pays for the two copies (the per-conv
    readings in PERF.md §6: bf16, H100)."""
    return channels >= 192 and (kernel - 1) * dilation >= 30


def phased_convs(cfg: ModelConfig) -> list:
    """(C, k, d) of each conv that a forward runs through the phase split."""
    chans = [cfg.upsample_initial_channel // 2 ** (i + 1) for i in range(len(cfg.upsample_rates))]
    return [(c, k, d) for c in chans for k, rd in zip(cfg.resblock_kernels, cfg.resblock_dilations) for d in rd
            if phase_split(c, k, d)]


def _offsets(up: Mapping, amps: Sequence, dtype):
    """A stage's residual streams hold x̃ = x - offset, per channel: the transposed
    conv's bias and, past each dilation, the bias of its pair's second conv. Returns
    (for each AMP block the offset its stream carries before each dilation, f32 [C];
    the offset of the blocks' mean, in `dtype`), built once per (dtype, device) on
    the stage's node."""
    def build():
        blocks, total = [], 0.0
        for block in amps:
            off, steps = up["b"].float(), []
            for c2 in block["convs2"]:
                steps.append(off)
                off = off + c2["b"].float()
            blocks.append(steps)
            total = total + off
        return blocks, (total / len(amps)).to(dtype)

    return layers.cached_frozen(amps, ("bigvgan_offsets", dtype, up["b"].device), build)


def _amp_block(p: Mapping, acts: Mapping, x: torch.Tensor, dilations: Sequence[int], offsets, dtype) -> torch.Tensor:
    """One AMP block on x̃, the stage's stream less `offsets[0]`; returns its output
    less the offset after the last dilation."""
    for c1, c2, a1, a2, d, off in zip(p["convs1"], p["convs2"], acts["a1"], acts["a2"], dilations, offsets):
        a = _act(a1, x, off)
        if phase_split(x.shape[2], c1["w"].shape[0], d):
            xt = layers.conv1d_phased(c1, a, d, dtype)
        else:
            xt = layers.conv1d_nwc(c1, a, dtype, dilation=d, bias=False)
        xt = layers.conv1d_nwc(c2, _act(a2, xt, c1["b"]), dtype, bias=False)
        x = xt + x
    return x


def _forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    x = layers.conv1d_nwc(params["conv_pre"], mel, dtype)
    for i, (up, amps, acts, rate) in enumerate(zip(params["ups"], params["amps"], params["acts"], cfg.upsample_rates)):
        with prof.stage(f"bigvgan.up{i}"):
            x = layers.conv1d_transpose_nwc(up, x, rate, dtype)
        with prof.stage(f"bigvgan.amp{i}"):
            offsets, mean_offset = _offsets(up, amps, dtype)
            acc = None
            for block, act, rd, offs in zip(amps, acts, cfg.resblock_dilations, offsets):
                y = _amp_block(block, act, x, rd, offs, dtype)
                acc = y if acc is None else acc + y
            x = torch.add(mean_offset, acc, alpha=1.0 / len(amps))
    x = layers.conv1d_nwc(params["conv_post"], _act(params["act_post"], x), dtype)
    return torch.clamp(x[..., 0].float(), -1.0, 1.0)
