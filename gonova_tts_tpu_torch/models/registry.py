"""Model registry: named model families with init/forward entry points.

The port's counterpart of `gonova_tts_tpu/models/registry.py`, over the port's own
modules. `init(g, cfg)` builds a family's parameters from a `torch.Generator`;
`forward` is the same function the JAX family names. The HiFi-GAN family
(`novagan`) routes its forward through `tts.hifigan_forward_fn`, the rule the
pipeline uses, so `hifigan_folded` picks the layout on both call paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from ..config import ModelConfig
from . import acoustic, bigvgan, f5, speaker, tts, vocoder, vocos


@dataclass(frozen=True)
class ModelFamily:
    name: str
    kind: str  # "acoustic" | "vocoder" | "speaker" | "pipeline"
    description: str
    init: Callable
    forward: Callable


_REGISTRY: Dict[str, ModelFamily] = {}


def register(family: ModelFamily) -> None:
    _REGISTRY[family.name] = family


def get(name: str) -> ModelFamily:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model family {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> Dict[str, ModelFamily]:
    return dict(_REGISTRY)


def _acoustic_init(g: torch.Generator, cfg: ModelConfig) -> acoustic.AcousticModel:
    return acoustic.AcousticModel(cfg, g)


def _novagan_forward(params, mel, cfg: ModelConfig, dtype=torch.float32):
    return tts.hifigan_forward_fn(cfg)(params, mel, cfg, dtype)


def _tts_init(g: torch.Generator, cfg: ModelConfig) -> tts.TTS:
    return tts.TTS(cfg, g)


register(
    ModelFamily(
        name="novaspeech",
        kind="acoustic",
        description="FastPitch-class non-AR acoustic model (phonemes+speaker → mel)",
        init=_acoustic_init,
        forward=acoustic.forward,
    )
)
register(
    ModelFamily(
        name="f5tts",
        kind="acoustic",
        description="F5-TTS v1 DiT (transcribed prompt + characters → mel by guided flow matching)",
        init=f5.init,
        forward=f5.sample,
    )
)
register(
    ModelFamily(
        name="novagan",
        kind="vocoder",
        description="HiFi-GAN-class generator (mel → 24 kHz waveform; lane-folded by default)",
        init=vocoder.init,
        forward=_novagan_forward,
    )
)
register(
    ModelFamily(
        name="novavocos",
        kind="vocoder",
        description="iSTFT-head frame-rate vocoder (Vocos-class, the serving vocoder)",
        init=vocos.init,
        forward=vocos.forward,
    )
)
register(
    ModelFamily(
        name="bigvgan",
        kind="vocoder",
        description="BigVGAN-v2 generator (mel → waveform; AMP blocks, anti-aliased Snake-beta kernel)",
        init=bigvgan.init,
        forward=bigvgan.forward,
    )
)
register(
    ModelFamily(
        name="novaspk",
        kind="speaker",
        description="Speaker encoder for one-shot voice cloning (mel → 256-d embedding)",
        init=speaker.init,
        forward=speaker.forward,
    )
)
register(
    ModelFamily(
        name="novatts",
        kind="pipeline",
        description="Full pipeline: acoustic + vocoder + speaker encoder",
        init=_tts_init,
        forward=tts.synthesize,
    )
)
