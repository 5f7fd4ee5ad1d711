"""Voice-clone similarity of the port's engine: same voice against other voices.

The port's copy of the JAX package's clone_eval.py, with its flags and JSON keys:
speaker-encoder cosine similarity between each cloning reference and the speech
synthesized in its voice, against the similarity to the other references (the
discriminability margin is what matters; with an untrained checkpoint the absolute
numbers mean nothing).

    python -m gonova_tts_tpu_torch.tools.clone_eval [--voices-dir DIR] [--checkpoint CKPT] [--device cpu]

Without `--voices-dir` (or with a directory holding no WAV) it clones four
synthetic voices. Runs on CUDA unless `--device cpu`. Prints one JSON line: mean
same-voice similarity, mean cross-voice similarity, margin.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..engine import TTSEngine
from ..utils import read_wav
from .eval_checkpoint import clone_margin, clone_similarities


def synthetic_voices(sr: int = 24000, n: int = 4, seconds: float = 5.0) -> List[Tuple[str, np.ndarray, int]]:
    """`n` amplitude-modulated tones at 120, 180, ... Hz with a little noise (seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        t = np.arange(int(seconds * sr)) / sr
        f = 120 + 60 * i
        audio = (
            0.4 * np.sin(2 * np.pi * f * t) * (0.6 + 0.4 * np.sin(2 * np.pi * (2 + i) * t))
            + 0.02 * rng.standard_normal(len(t))
        ).astype(np.float32)
        out.append((f"synthetic_{i}", audio, sr))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voices-dir", default=None, help="dir of reference WAVs (else synthetic)")
    ap.add_argument("--text", default="The quick brown fox jumps over the lazy dog.")
    ap.add_argument("--checkpoint", default=None, help="npz or training root (trained weights)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def evaluate(args: argparse.Namespace, cfg: Optional[Config] = None) -> dict:
    """The similarity JSON. `cfg` replaces `Config()` (checkpoint, warm-up and
    device set from `args`)."""
    cfg = (cfg or Config()).model_copy(deep=True)
    cfg.engine.warmup_shapes = []
    if args.checkpoint:
        cfg.model.model_path = args.checkpoint
    if args.device:
        cfg.model.device = args.device
    engine = TTSEngine(cfg)
    engine.load(warmup=False)

    refs = []
    if args.voices_dir:
        for path in sorted(glob.glob(os.path.join(args.voices_dir, "*.wav")))[:8]:
            audio, sr = read_wav(path)
            refs.append((os.path.basename(path), np.asarray(audio, np.float32), sr))
    if not refs:
        refs = synthetic_voices()

    ref_embs = {name: engine.embed_voice(audio, sr) for name, audio, sr in refs}
    same, cross, _ = clone_similarities(engine, args.text, ref_embs, [name for name, _, _ in refs])
    return {
        "metric": "voice_clone_similarity",
        "voices": len(refs),
        "same_voice_mean": round(float(np.mean(same)), 4),
        "cross_voice_mean": round(float(np.mean(cross)), 4),
        "margin": round(clone_margin(same, cross), 4),
    }


def main(argv=None, cfg: Optional[Config] = None) -> dict:
    result = evaluate(parse_args(argv), cfg)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
