"""Irreducible-error floor for the held-out generalization grades.

The port's copy of the JAX package's tools/jitter_floor.py, with its flags and JSON
keys. The corpus generator seeds per-token duration jitter on (symbol, position,
TEXT) (`train/synth_corpus.py:utterance_durations`). For held-out sentences a model
cannot know the realization, only the class-conditional distribution, so even a
perfect model pays a mel-L1 floor against the ground-truth wav. Two floors:

  floor_alt_jitter : the generator re-renders each held-out utterance with a SALTED
                     jitter key (same distribution, another iid realization), graded
                     against its own ground truth: the expected error of a model
                     that samples from the true duration distribution.
  floor_mean_dur   : re-rendered with every token at its class-MEAN duration: the
                     error of the optimal deterministic duration predictor.

Both renditions use the generator's own segment synthesis, so spectral content is
exact and the floor isolates duration unpredictability. Graded as
tools/eval_checkpoint.py grades: mel L1 over the overlapping prefix, the plain f32
log-mel (on `--device`: CUDA unless `--device cpu`).

    python -m gonova_tts_tpu_torch.tools.jitter_floor --corpus DIR [--heldout 2] [--device cpu]

Prints one JSON line; exits 1 with an "error" line when the corpus has no variable
durations or no held-out sentences.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np
import torch

from ..audio.mel import mel_spectrogram
from ..config import ModelConfig
from ..device import resolve_device
from ..text import text_to_ids
from ..text.symbols import SYMBOLS
from ..train import synth_corpus as sc
from ..utils import read_wav


def mean_durations(ids, text: str, rate_variation: bool) -> List[int]:
    """Class-mean frame counts, the optimal deterministic predictor's output. The
    means follow utterance_durations' class ranges: vowels 4+U{0..3} → 5.5,
    sonorants 3+U{0..2} → 4, noise 3.5, stops 2.5, other 3.5."""
    rate = sc.rate_for_text(text) if rate_variation else 1.0
    out = []
    for tok in ids:
        sym = SYMBOLS[tok]
        if sym and sym[-1] in "012":
            sym = sym[:-1]
        if sym in sc._VOWEL_FORMANTS:
            mean = 5.5
        elif sym in sc._SONORANT_FORMANTS:
            mean = 4.0
        elif sym in sc._NOISE_RECIPES:
            mean = 3.5
        elif sym in sc._STOP_RECIPES:
            mean = 2.5
        else:
            mean = 3.5
        out.append(max(1, int(round(mean * rate))))
    return out


def mel_of(wav: np.ndarray, cfg: ModelConfig, device) -> np.ndarray:
    """[frames, n_mels] log-mel of `wav`, computed as the JAX tool computes it: the
    audio zero-padded to a power-of-two length of at least 16,384 samples, then the
    first 1 + len // hop frames kept. The padding decides what the last frames see
    (zeros, not the mel's reflection of the audio), so it stays."""
    n = len(wav)
    padded = np.zeros(1 << max(14, (n - 1).bit_length()), np.float32)
    padded[:n] = wav
    frames = 1 + n // cfg.hop_length
    with torch.inference_mode():
        m = mel_spectrogram(
            torch.as_tensor(padded, device=device)[None], sr=cfg.sample_rate, n_fft=cfg.n_fft,
            hop_length=cfg.hop_length, win_length=cfg.win_length, n_mels=cfg.n_mels,
            fmin=cfg.fmin, fmax=cfg.fmax,
        )[0][:frames]
    return m.cpu().numpy()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True, help="synth_corpus output dir")
    ap.add_argument("--heldout", type=int, default=-1,
                    help="last-N sentences per speaker to grade (default: the corpus meta's holdout)")
    ap.add_argument("--max-speakers", type=int, default=8)
    ap.add_argument("--salt", default="\x00altseed", help="jitter-key salt")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def evaluate(args: argparse.Namespace) -> dict:
    """The floors' JSON, or {"error": ...} for a corpus without variable durations or
    a held-out split."""
    meta = sc.load_corpus_meta(args.corpus)
    sentences = meta["sentences"]
    speakers = meta["speakers"][: args.max_speakers]
    rate_variation = meta["rate_variation"]
    n_held = meta["holdout"] if args.heldout < 0 else args.heldout
    if not meta["variable"] or n_held <= 0:
        return {"error": "corpus has no variable durations or no holdout"}
    device = resolve_device(args.device)
    cfg = ModelConfig()

    alt_l1, mean_l1, alt_len, mean_len = [], [], [], []
    for spk in speakers:
        for i in range(len(sentences) - n_held, len(sentences)):
            text = sentences[i]
            gt_path = os.path.join(args.corpus, f"{spk.name}_{i:02d}.wav")
            if not os.path.exists(gt_path):
                continue
            gt, _ = read_wav(gt_path)
            m_gt = mel_of(np.asarray(gt, np.float32), cfg, device)
            # Another iid jitter realization.
            alt, _ = sc.synthesize_utterance(
                text, spk, cfg, variable=True, rate_variation=rate_variation, jitter_salt=args.salt,
            )
            # The optimal deterministic (class-mean) durations.
            md = mean_durations(text_to_ids(text), text, rate_variation)
            mean, _ = sc.synthesize_utterance(text, spk, cfg, variable=True, durations=md)
            for wav, l1s, lens in ((alt, alt_l1, alt_len), (mean, mean_l1, mean_len)):
                m = mel_of(wav, cfg, device)
                t = min(len(m_gt), len(m))
                l1s.append(float(np.abs(m[:t] - m_gt[:t]).mean()))
                lens.append(len(m) / max(len(m_gt), 1))

    return {
        "corpus": args.corpus,
        "n_utterances": len(alt_l1),
        "n_speakers": len(speakers),
        "floor_alt_jitter_mel_l1": round(float(np.mean(alt_l1)), 4),
        "floor_mean_dur_mel_l1": round(float(np.mean(mean_l1)), 4),
        "alt_len_ratio": round(float(np.mean(alt_len)), 4),
        "mean_len_ratio": round(float(np.mean(mean_len)), 4),
    }


def main(argv=None) -> int:
    """Print the floors as one JSON line; 1 when the corpus cannot give them."""
    result = evaluate(parse_args(argv))
    print(json.dumps(result), flush=True)
    return 1 if "error" in result else 0


if __name__ == "__main__":
    sys.exit(main())
