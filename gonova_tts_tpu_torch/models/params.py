"""Carry JAX parameter trees into the port's modules.

A JAX parameter tree — from `tts.init`, or restored from a checkpoint — is nested
dicts and lists of arrays. The port's `TTS` module mirrors it key for key
(`acoustic/encoder/blocks/0/attn/q/w` is `tts.acoustic.encoder.blocks[0].attn.q.w`),
in the same layouts, so loading is a strict, shape-checked copy.

The compact checkpoint format is the JAX package's `save_params_npz`: '/'-joined
tree paths, all-digit levels are list indices, f16 leaves (upcast to f32 here),
and frontend metadata as JSON bytes under `__meta__`.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from .tts import TTS

logger = logging.getLogger("gonova_tts_tpu_torch.params")

META_KEY = "__meta__"


def load_npz(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(nested f32 numpy tree, metadata dict) from a `save_params_npz` file."""
    with np.load(path) as z:
        flat = {k: np.asarray(z[k], np.float32) for k in z.files if k != META_KEY}
        meta = (
            json.loads(bytes(np.asarray(z[META_KEY])).decode("utf-8"))
            if META_KEY in z.files else {}
        )
    try:
        return unflatten(flat), meta
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """'/'-joined leaf paths → the nested tree; all-digit levels become lists."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            idx = sorted(int(k) for k in out)
            if idx != list(range(len(out))):
                raise ValueError(f"non-contiguous list indices {idx}")
            return [out[str(i)] for i in idx]
        return out

    return listify(root)


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined leaf paths of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def infer_vocos_head(tree: Dict[str, Any], cfg: ModelConfig) -> ModelConfig:
    """The STFT-head flavour is encoded in the head width (2*bins polar, 3*bins
    cartesian); a checkpoint serves with the head it was trained with. Other
    families have no head: their config is returned as given."""
    if cfg.vocoder_family != "vocos":
        return cfg
    try:
        head_w = int(np.shape(tree["vocoder"]["head"]["w"])[-1])
    except (KeyError, TypeError):
        return cfg  # no vocos head in this tree: the config rules
    n_bins = cfg.n_fft // 2 + 1
    inferred = {2 * n_bins: "polar", 3 * n_bins: "cartesian"}.get(head_w)
    if inferred is not None and inferred != cfg.vocos_head:
        logger.info("vocos head inferred from width %d: %s (configured %s)", head_w, inferred, cfg.vocos_head)
        cfg = cfg.model_copy(update={"vocos_head": inferred})
    return cfg


def replay_stress(meta: Dict[str, Any]) -> None:
    """Stress-marked tokenization is a property of the checkpoint: replay the
    recorded mode into the frontend (mismatched ids are silent quality loss)."""
    from ..text import frontend

    ck_stress = meta.get("stress")
    if ck_stress is not None and bool(ck_stress) != frontend.stress_enabled():
        logger.warning("stress mode %s set by the checkpoint", bool(ck_stress))
        frontend.set_stress(bool(ck_stress))


def _load_strict(module: torch.nn.Module, tree: Dict[str, Any], device) -> torch.nn.Module:
    """Copy a numpy tree into `module`: every leaf must land in a parameter of the
    same path and shape, and every parameter must be covered."""
    state = module.state_dict()
    flat = {k.replace("/", "."): v for k, v in flatten(tree).items()}
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    wrong = sorted(k for k in set(flat) & set(state) if tuple(flat[k].shape) != tuple(state[k].shape))
    if missing or unexpected or wrong:
        raise ValueError(
            f"parameter tree does not fit the model: missing {missing[:5]}, "
            f"unexpected {unexpected[:5]}, shape mismatch {wrong[:5]}"
        )
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in flat.items()})
    return module.to(resolve_device(device))


def from_numpy_tree(tree: Dict[str, Any], cfg: ModelConfig, device=None, with_aligner: bool = False) -> TTS:
    """A JAX parameter tree (numpy leaves) → the port's `TTS` module on `device`
    (CUDA unless the caller asks for the CPU).

    Every leaf of the `acoustic`, `vocoder` and `speaker` subtrees (and of
    `aligner` with `with_aligner=True`, for training) must land in a parameter of
    the same path and shape, and every parameter must be covered; other top-level
    subtrees are skipped (serving skips a training-time aligner). The vocoder is the
    family `cfg.vocoder_family` names (a HiFi-GAN tree nests lists:
    `vocoder/mrfs/i/j/convs1/k/w`; a BigVGAN tree `vocoder/amps/i/j/convs1/d/w` and
    `vocoder/acts/i/j/a1/d/alpha`). `cfg` should already carry
    `infer_vocos_head`'s answer."""
    served = ("acoustic", "vocoder", "speaker") + (("aligner",) if with_aligner else ())
    return _load_strict(TTS(cfg, with_aligner=with_aligner), {k: tree[k] for k in served if k in tree}, device)


def discriminators_from_numpy(tree: Dict[str, Any], width: float, device=None) -> torch.nn.Module:
    """The JAX package's `{"mpd": mpd_init(...), "msd": msd_init(...)}` tree at
    `disc_width` `width` → the port's discriminators, strictly as `from_numpy_tree`."""
    from .vocoder import discriminators_init

    g = torch.Generator().manual_seed(0)
    return _load_strict(discriminators_init(g, g, width), {k: tree[k] for k in ("mpd", "msd")}, device)


def latest_step_dir(root: str) -> Optional[str]:
    """The newest `step_NNNNNNNN` entry under root (a port `.npz` or a JAX orbax
    directory), or None."""
    if not os.path.isdir(root):
        return None
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    return os.path.join(root, steps[-1]) if steps else None


def resolve_checkpoint(path: str) -> str:
    """A `.npz` file as given; a training root (`train/checkpoint.save_params`)
    → its newest `step_NNNNNNNN.npz`."""
    if os.path.isdir(path):
        newest = latest_step_dir(path)
        if newest is None or not newest.endswith(".npz"):
            raise ValueError(f"{path}: no step_NNNNNNNN.npz checkpoint in this training root")
        return newest
    return path


def load_checkpoint(path: str, cfg: ModelConfig, device=None) -> Tuple[TTS, ModelConfig]:
    """Restore a `.npz` checkpoint, or the newest step of a training root, of the
    family `cfg.vocoder_family` names: head inference, stress replay, then the
    module."""
    tree, meta = load_npz(resolve_checkpoint(path))
    cfg = infer_vocos_head(tree, cfg)
    replay_stress(meta)
    return from_numpy_tree(tree, cfg, device), cfg
