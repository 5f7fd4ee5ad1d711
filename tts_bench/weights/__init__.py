"""Weights the benchmark makes: a configuration's `generate` section names their
`kind`, a module of this folder (`weights/<kind>.py`, with `make(model, seed,
device)` → {tree path: array}). They are written beside the checkpoint's subtrees
that the section `keep`s, into one npz in the served checkpoint format ('/'-joined
tree paths), which the engine loads through `model.model_path`.
"""

from __future__ import annotations

import os

import numpy as np


def assemble(checkpoint: str, generate: dict, model: dict, seed: int, device, tmp: str, here: str) -> str:
    """The npz the engine loads: the checkpoint's `keep` subtrees and the made ones."""
    from tts_bench import spec

    with np.load(checkpoint) as z:
        tree = {k: z[k] for k in z.files if k.split("/")[0] in generate["keep"] or k == "__meta__"}
    tree.update(spec.module("weights", generate["kind"], here).make(model, seed, device))
    path = os.path.join(tmp, "served.npz")
    np.savez(path, **tree)
    return path
