"""A tiny configuration for the CPU tests: a seeded checkpoint of the served model at
small widths, and cells that serve it with a light version of each mix."""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from tts_bench import spec

TINY = {
    "d_model": 32, "n_heads": 2, "d_ff": 64, "encoder_layers": 1, "decoder_layers": 1,
    "speaker_dim": 32, "vocos_dim": 32, "vocos_ff": 64, "vocos_layers": 1,
    "upsample_initial_channel": 32, "compute_dtype": "float32",
}


def checkpoint(path: str, family: str = "vocos", seed: int = 0) -> str:
    """A '/'-keyed npz of the served model at TINY widths, seeded."""
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import tts

    cfg = ModelConfig(**TINY, vocoder_family=family)
    model = tts.TTS(cfg, torch.Generator().manual_seed(seed))
    np.savez(path, **{k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()})
    return path


def cell(name: str, tmp: str, family: str = "vocos", here: str = spec.HERE, bench: dict = None, **mix) -> spec.Cell:
    """The named cell (found under `here`) served at TINY widths from a checkpoint
    under `tmp`, its mix lightened (`mix` overrides)."""
    c = spec.load_cell(name, here=here, bench=bench or spec.benchmark())
    c = copy.deepcopy(c)
    path = os.path.join(tmp, f"tiny_{family}.npz")
    if not os.path.exists(path):
        checkpoint(path, family)
    c.config = dict(c.config, checkpoint=path, model=dict(c.config.get("model", {}), **TINY), engine={})
    if family == "hifigan":
        c.config["model"]["vocoder_family"] = "hifigan"
        c.config.pop("generate", None)
    light = {"ramp_s": 0.5, "sample": 4, "trace_at_s": 0.5, "trace_s": 0.5,
             "warmup_shapes": [[1, 32], [4, 32], [1, 64]]}
    if c.mix["loop"] == "closed":
        light.update(clients=2, doc_sentences={"dist": "uniform", "min": 2, "max": 3},
                     words={"dist": "uniform", "min": 3, "max": 8})
    else:
        light.update(rate=4.0, clone_share=0.25, sample_cloned=1,
                     words={"dist": "uniform", "min": 3, "max": 8})
    c.mix.update(light, **mix)
    return c

