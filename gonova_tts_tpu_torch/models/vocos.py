"""NovaVocos — iSTFT-head vocoder (Vocos-class), in PyTorch.

Counterpart of `gonova_tts_tpu/models/vocos.py`: mel [B, T, n_mels] → k=7 embed
conv → L ConvNeXt blocks (depthwise k=7, LN, 512→1536→512 tanh-GELU MLP, layer
scale) → LN → STFT head (polar or cartesian) → window-folded inverse-DFT product
→ 4-shift overlap-add → waveform [B, T * hop].
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.stft import hann_window, idft_bases
from ..config import ModelConfig
from ..ops import vocos_stack as vs_op
from ..parallel import tp
from . import graphs, layers
from .layers import Tree


def _block(g: torch.Generator, dim: int, ff: int, kernel: int) -> Tree:
    node = layers.leaf(
        dw=torch.randn((kernel, dim), generator=g) * (1.0 / np.sqrt(kernel)),
        dw_b=torch.zeros(dim),
        gamma=torch.full((dim,), 1e-2),
    )
    node.add_module("ln", layers.layernorm_init(dim))
    node.add_module("pw1", layers.dense_init(g, dim, ff))
    node.add_module("pw2", layers.dense_init(g, ff, dim))
    return node


def _depthwise_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """Depthwise SAME conv; w [k, C], x [B, T, C]."""
    k, c = w.shape
    y = F.conv1d(x.to(dtype).transpose(1, 2), w.to(dtype).t()[:, None, :], padding=k // 2, groups=c)
    return y.transpose(1, 2) + b.to(dtype)


def _block_apply(p: Mapping, x: torch.Tensor, dtype, tiled: bool = False) -> torch.Tensor:
    h = _depthwise_conv(p["dw"], p["dw_b"], x, dtype)
    if tiled:
        # The conv's output is [B, C, T] memory seen as [B, T, C]: over that strided
        # last dim the CPU's LayerNorm reductions vectorize across rows and sum the
        # rows past the last full vector in another order, by the row's position.
        h = h.contiguous()
    h = layers.layernorm(p["ln"], h)
    h = layers.dense(p["pw1"], h, dtype, tiled=tiled)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu is the tanh form
    h = layers.dense(p["pw2"], h, dtype, tiled=tiled)
    return x + h * p["gamma"].to(h.dtype)


def _embed(p: Mapping, mel: torch.Tensor, dtype, tiled: bool) -> torch.Tensor:
    """The k=7 SAME embed conv; `tiled`: as one `tiled_matmul` over K = 7 * n_mels
    (the columns [mel[t-3], ..., mel[t+3]], zero rows past the ends)."""
    w = p["w"]
    if not tiled or tp.split_dim(w) is not None:
        return layers.conv1d(p, mel.to(dtype), dtype=dtype)
    k, t = w.shape[0], mel.shape[1]
    x = F.pad(mel.to(dtype), (0, 0, k // 2, k // 2))
    cols = torch.cat([x[:, j : j + t] for j in range(k)], dim=-1)
    return layers.tiled_matmul(cols, w.to(dtype).reshape(-1, w.shape[-1])) + p["b"].to(dtype)


class Vocos(Tree):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        n_bins = cfg.n_fft // 2 + 1
        head_mult = {"polar": 2, "cartesian": 3}[cfg.vocos_head]
        self.cfg = cfg
        self.embed = layers.conv1d_init(g, cfg.n_mels, cfg.vocos_dim, 7)
        self.blocks = nn.ModuleList(
            _block(g, cfg.vocos_dim, cfg.vocos_ff, 7) for _ in range(cfg.vocos_layers)
        )
        self.ln_out = layers.layernorm_init(cfg.vocos_dim)
        self.head = layers.dense_init(g, cfg.vocos_dim, head_mult * n_bins)

    def forward(self, mel: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return forward(self, mel, self.cfg, dtype)


def init(g: torch.Generator, cfg: ModelConfig) -> Vocos:
    return Vocos(cfg, g)


def reach_frames(cfg: ModelConfig) -> int:
    """Mel frames each side that one output sample can depend on: the embedding conv's
    and every ConvNeXt block's 3 (k=7), and the iSTFT's 2 (n_fft = 4 hops)."""
    return 3 * (cfg.vocos_layers + 1) + 2


def forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype=torch.float32) -> torch.Tensor:
    """mel [B, T, n_mels] → waveform [B, T * hop] (f32). Replayed from a CUDA graph
    where the serving pass has one (`graphs.run`)."""
    return graphs.run("vocos.forward", lambda: _forward(params, mel, cfg, dtype), params, (mel,), id(cfg), dtype)


def _forward(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    n_fft, hop = cfg.n_fft, cfg.hop_length
    if n_fft != 4 * hop or cfg.win_length != n_fft:
        raise ValueError("NovaVocos assumes 4x-overlap framing with the full n_fft Hann "
                         "(n_fft == 4 * hop_length, win_length == n_fft)")
    n_bins = n_fft // 2 + 1
    t = mel.shape[1]
    # A pass without autograd (serving) takes each product in fixed row tiles, so
    # that a streamed window's rows equal the same rows of the batch pass bit for bit
    # (the engine's streaming invariant). A training pass takes one product each.
    tiled = not torch.is_grad_enabled()

    x = _embed(params["embed"], mel, dtype, tiled)
    if cfg.vocos_pallas and t <= vs_op.MAX_T:
        blocks = params["blocks"]
        packed = layers.cached(
            blocks, ("vocos_stack", dtype, x.device), lambda: vs_op.pack_params(blocks, dtype)
        )
        x = vs_op.vocos_stack(x, packed, bf16=(dtype == torch.bfloat16)).to(dtype)
    else:
        for blk in params["blocks"]:
            x = _block_apply(blk, x, dtype, tiled)
    x = layers.layernorm(params["ln_out"], x)
    head = layers.dense(params["head"], x, dtype, tiled=tiled).float()

    mag = torch.exp(torch.clamp(head[..., :n_bins], -14.0, 6.0))
    if cfg.vocos_head == "cartesian":
        xdir = head[..., n_bins : 2 * n_bins]
        ydir = head[..., 2 * n_bins :]
        inv = torch.rsqrt(xdir * xdir + ydir * ydir + 1e-12)
        real, imag = mag * xdir * inv, mag * ydir * inv
    else:
        phase = head[..., n_bins:]
        real, imag = mag * torch.cos(phase), mag * torch.sin(phase)
    # The port computes the iDFT in full f32 for every istft_precision setting: a
    # CUDA f32 matmul is exact f32 with TF32 off (device.resolve_device pins it).
    return istft_synthesis(real, imag, n_fft, hop, tiled)


def _synthesis_bases(n_fft: int) -> np.ndarray:
    icos, isin = idft_bases(n_fft)
    return np.concatenate([icos, -isin], axis=0) * hann_window(n_fft)[None, :]


def synthesis_bases(n_fft: int, device) -> torch.Tensor:
    """The inverse-DFT bases with the synthesis window folded in, [n_fft + 2, n_fft]
    f32 on `device`, built once."""
    return layers.device_constant(("vocos.synthesis_bases", n_fft), lambda: _synthesis_bases(n_fft), device)


def istft_synthesis(
    real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int, tiled: bool = False
) -> torch.Tensor:
    """Windowed iSTFT for 4x-overlap framing: [B, T, bins] x2 → [B, T * hop].

    Inverse real DFT as one product with the synthesis window folded into the
    bases, four shifted adds, the constant NOLA normalization 1.5 (periodic Hann
    at 4x overlap), and a 1.5*hop lead trim aligning sample 0 with frame 0."""
    b, t, _ = real.shape
    bases = synthesis_bases(n_fft, real.device)
    spec = torch.cat([real, imag], dim=-1)
    frames = layers.tiled_matmul(spec, bases) if tiled else spec @ bases  # [B, T, n_fft]
    segs = frames.reshape(b, t, 4, hop)
    out = torch.zeros((b, (t + 3) * hop), device=real.device)
    for k in range(4):
        out[:, k * hop : (k + t) * hop] += segs[:, :, k, :].reshape(b, t * hop)
    out = out / 1.5
    lead = (n_fft - hop) // 2
    return out[:, lead : lead + t * hop]
