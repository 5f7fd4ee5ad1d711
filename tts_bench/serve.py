"""Set-up of a cell: the port's service as `gonova-tts-torch serve` builds it, with
the configuration's fields, the cell's warm-up shapes, the loop's voices made from
the seed, and every cache and file of the run under the run's temporary directory.
"""

from __future__ import annotations

import os
from typing import List

from . import spec, weights
from .spec import ROOT, Cell
from .voices import Voice


def port_config(cell: Cell, seed: int, device: str, tmp: str):
    """The port `Config` the cell serves: defaults, then the configuration file's
    `model` and `engine` fields, then what the run decides (checkpoint path, device,
    the cell's warm-up shapes, the voice cache, the default voice, WARNING logs)."""
    from gonova_tts_tpu_torch.config import Config

    cfg = Config()
    for section in ("model", "engine"):
        for key, value in cell.config.get(section, {}).items():
            setattr(getattr(cfg, section), key, value)
    checkpoint = os.path.join(ROOT, cell.config["checkpoint"])
    generate = cell.config.get("generate")
    if generate:
        checkpoint = weights.assemble(checkpoint, generate, cfg.model.model_dump(), seed, device, tmp, cell.here)
    cfg.model.model_path = checkpoint
    cfg.model.device = device
    cfg.engine.warmup_shapes = cell.mix["warmup_shapes"]
    cfg.voice_cloning.cache_dir = os.path.join(tmp, "voices")
    cfg.voice_cloning.default_voice_path = os.path.join(ROOT, "assets", "default_voice.wav")
    cfg.logging.level = "WARNING"
    return cfg


def make_voices(cell: Cell, seed: int) -> List[Voice]:
    """The reference recordings the cell's loop registers, made from the seed."""
    return [Voice(seed, i, sr) for i, sr in enumerate(spec.loop(cell).voice_rates(cell.mix))]


async def start(cell: Cell, cfg, voices: List[Voice]):
    """The service loaded and warmed, with the loop's own set-up (its voices) done:
    ready for traffic."""
    from gonova_tts_tpu_torch.service.server import TTSService

    svc = TTSService(cfg)
    await svc.start()
    await spec.loop(cell).warm(svc, cell.mix, voices)
    return svc
