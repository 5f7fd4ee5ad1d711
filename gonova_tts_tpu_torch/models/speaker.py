"""NovaSpk speaker encoder: parameters only, for now.

Counterpart of `gonova_tts_tpu/models/speaker.py`. Checkpoints carry the speaker
subtree, so the port loads and keeps it; the encoder's forward pass (three
stride-2 convs with JAX's asymmetric SAME padding, masked pooling) belongs to the
voice-embedding path, which the text → PCM path does not run.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from . import layers
from .layers import Tree


def init(g: torch.Generator, cfg: ModelConfig, hidden: int = 256) -> Tree:
    return layers.group(
        c1=layers.conv1d_init(g, cfg.n_mels, hidden, 5),
        c2=layers.conv1d_init(g, hidden, hidden, 5),
        c3=layers.conv1d_init(g, hidden, hidden, 3),
        ln1=layers.layernorm_init(hidden),
        ln2=layers.layernorm_init(hidden),
        ln3=layers.layernorm_init(hidden),
        out=layers.dense_init(g, 2 * hidden, cfg.speaker_dim),
    )
