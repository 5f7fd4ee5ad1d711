"""Checkpoint save/restore in the npz form both packages read.

Counterpart of `gonova_tts_tpu/train/checkpoint.py`'s npz half. A checkpoint is
one `.npz`: '/'-joined tree paths (`acoustic/encoder/blocks/0/attn/q/w`) → arrays,
all-digit levels are list indices, and the frontend metadata as JSON bytes under
`__meta__`. The JAX package's `restore_params_npz` reads these files, and the
port's `models/params.py` reads the JAX package's.

A training root holds one file per saved step, `step_NNNNNNNN.npz`, in f32. The
port writes no orbax directory (that format needs the JAX package); the JAX
package reads a port step through its file path.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.params import META_KEY, flatten, latest_step_dir, load_npz, resolve_checkpoint

__all__ = [
    "flat_arrays", "latest_step_dir", "load_meta", "restore_params", "restore_params_npz",
    "save_params", "save_params_npz",
]


def _default_meta() -> Dict[str, Any]:
    """Frontend-mode facts the serving engine must replay to feed the checkpoint
    the token inventory it was trained on (stress-marked ids)."""
    from ..text import frontend

    return {"format_version": 1, "stress": frontend.stress_enabled()}


def flat_arrays(params: Any) -> Dict[str, np.ndarray]:
    """'/'-joined path → numpy array, from a module (its parameters), a flat
    mapping of '.'-joined names (an EMA shadow) or a nested dict/list tree."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    if isinstance(params, Mapping) and all(isinstance(v, torch.Tensor) for v in params.values()):
        return {k.replace(".", "/"): v.detach().float().cpu().numpy() for k, v in params.items()}
    return {k: np.asarray(v) for k, v in flatten(params).items()}


def save_params_npz(
    path: str, params: Any, dtype="float16", meta: Optional[Dict[str, Any]] = None
) -> str:
    """Compact single-file checkpoint: '/'-joined tree paths → `dtype` arrays
    (f16 by default: the repo-committable form), zip-compressed, with the frontend
    metadata embedded (see load_meta)."""
    flat = {k: v.astype(dtype) for k, v in flat_arrays(params).items()}
    payload = json.dumps(meta if meta is not None else _default_meta())
    flat[META_KEY] = np.frombuffer(payload.encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **flat)
    return path


def save_params(
    root: str, params: Any, step: int, meta: Optional[Dict[str, Any]] = None
) -> str:
    """A training checkpoint: `root/step_%08d.npz` in f32. Returns its path."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(os.path.abspath(root), f"step_{step:08d}.npz")
    return save_params_npz(path, params, dtype="float32", meta=meta)


def restore_params(path: str) -> Any:
    """Restore a nested numpy tree from a `.npz` or a training root's newest step."""
    return restore_params_npz(resolve_checkpoint(os.path.abspath(path)))


def restore_params_npz(path: str) -> Any:
    """The nested tree of a save_params_npz file (f32 leaves)."""
    return load_npz(path)[0]


def load_meta(path: str) -> Dict[str, Any]:
    """Frontend metadata recorded at save time ({} for files without it). Accepts
    the same path forms as restore_params."""
    try:
        with np.load(resolve_checkpoint(os.path.abspath(path))) as z:
            if META_KEY not in z.files:
                return {}
            return json.loads(bytes(np.asarray(z[META_KEY])).decode("utf-8"))
    except (OSError, ValueError):
        return {}
