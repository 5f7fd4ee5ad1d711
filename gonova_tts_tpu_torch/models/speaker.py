"""NovaSpk: speaker encoder for one-shot voice cloning.

Counterpart of `gonova_tts_tpu/models/speaker.py`. Reference log-mel (of
`ModelConfig.voice_n_mels` bands) → three
stride-2 convs (ReLU, then LayerNorm) → masked mean + std pooling → dense →
L2-normalized embedding.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..config import ModelConfig
from . import layers
from .layers import Tree


def init(g: torch.Generator, cfg: ModelConfig, hidden: int = 256) -> Tree:
    return layers.group(
        c1=layers.conv1d_init(g, cfg.voice_n_mels, hidden, 5),
        c2=layers.conv1d_init(g, hidden, hidden, 5),
        c3=layers.conv1d_init(g, hidden, hidden, 3),
        ln1=layers.layernorm_init(hidden),
        ln2=layers.layernorm_init(hidden),
        ln3=layers.layernorm_init(hidden),
        out=layers.dense_init(g, 2 * hidden, cfg.speaker_dim),
    )


def forward(
    params: Mapping,
    mel: torch.Tensor,  # [B, T, n_mels]
    frame_mask: torch.Tensor,  # [B, T] 1 = valid
    dtype=torch.float32,
) -> torch.Tensor:
    """→ [B, speaker_dim] f32, L2-normalized."""
    h = mel.to(dtype)
    mask = frame_mask.to(dtype)
    for conv, ln in (("c1", "ln1"), ("c2", "ln2"), ("c3", "ln3")):
        h = layers.conv1d(params[conv], h * mask[..., None], stride=2, dtype=dtype)
        h = layers.layernorm(params[ln], torch.relu(h))
        # Pool the mask at the same stride (source frame 2 * i decides output i).
        mask = mask[:, : h.shape[1] * 2 : 2]

    m = mask[..., None]
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    mean = (h * m).sum(dim=1) / denom
    var = (((h - mean[:, None, :]) ** 2) * m).sum(dim=1) / denom
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    pooled = torch.cat([mean, std], dim=-1)  # [B, 2H]
    emb = layers.dense(params["out"], pooled, dtype).float()
    return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-6)
