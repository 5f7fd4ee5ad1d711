"""Deterministic formant-synthesized training corpus.

The port's own copy of `gonova_tts_tpu/train/synth_corpus.py`: no speech data is
shipped, so this module renders a fully deterministic corpus whose text→audio
mapping is learnable by construction:

  * every phoneme token renders to `FRAMES_PER_TOKEN` mel frames of audio, or to
    a deterministic per-token count (`utterance_durations`) with variable=True;
  * vowels/sonorants are harmonic formant stacks (per-vowel F1/F2 from a standard
    ARPAbet table), fricatives are fixed band-passed noise, stops are bursts,
    boundaries/punctuation are silence;
  * speakers differ by base F0, formant scale, and spectral tilt;
  * a shared sentence-level F0 declination gives the pitch predictor a target.

Everything is seeded from in-repo text; regenerating the corpus is
byte-identical, and identical to the JAX package's corpus.

CLI:  python -m gonova_tts_tpu_torch.train.synth_corpus --out-dir corpus/
writes WAVs, a `manifest.txt` (wav|text lines) and per-speaker reference clips.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import ModelConfig
from ..text import text_to_ids
from ..text.symbols import SYMBOLS
from ..utils import write_wav

FRAMES_PER_TOKEN = 4  # 4 * hop(256) = 1024 samples ≈ 42.7 ms per phoneme @ 24 kHz

# Vowel formant targets (F1, F2) in Hz — classic Peterson/Barney-style values.
_VOWEL_FORMANTS: Dict[str, Tuple[float, float]] = {
    "AA": (730, 1090), "AE": (660, 1720), "AH": (640, 1190), "AO": (570, 840),
    "AW": (700, 1200), "AY": (660, 1400), "EH": (530, 1840), "ER": (490, 1350),
    "EY": (480, 1900), "IH": (390, 1990), "IY": (270, 2290), "OW": (450, 900),
    "OY": (500, 1100), "UH": (440, 1020), "UW": (300, 870),
}
# Sonorant consonants rendered vowel-like.
_SONORANT_FORMANTS: Dict[str, Tuple[float, float]] = {
    "L": (360, 1300), "R": (420, 1300), "W": (300, 610), "Y": (300, 2200),
    "M": (250, 1000), "N": (280, 1700), "NG": (280, 2300),
}
# Fricatives/affricates: (noise center Hz, bandwidth Hz, amplitude, voiced?).
_NOISE_RECIPES: Dict[str, Tuple[float, float, float, bool]] = {
    "S": (6000, 2200, 0.24, False), "SH": (3500, 1600, 0.26, False),
    "F": (5500, 3200, 0.14, False), "TH": (5800, 3200, 0.12, False),
    "HH": (1500, 2200, 0.12, False), "CH": (3200, 1800, 0.24, False),
    "Z": (6000, 2200, 0.18, True), "ZH": (3500, 1600, 0.18, True),
    "V": (5500, 3200, 0.12, True), "DH": (5800, 3200, 0.12, True),
    "JH": (3200, 1800, 0.18, True),
}
# Stops: (burst center Hz, amplitude, voiced?). Burst in the first quarter, rest quiet.
_STOP_RECIPES: Dict[str, Tuple[float, float, bool]] = {
    "P": (900, 0.22, False), "T": (4200, 0.24, False), "K": (2400, 0.24, False),
    "B": (600, 0.2, True), "D": (3000, 0.2, True), "G": (1700, 0.2, True),
}


@dataclass(frozen=True)
class Speaker:
    name: str
    f0: float  # base fundamental, Hz
    formant_scale: float  # vocal-tract length proxy
    tilt: float  # spectral tilt: harmonic amplitude ∝ (f0/f)^tilt


DEFAULT_SPEAKERS: Tuple[Speaker, ...] = (
    Speaker("spk_low", 110.0, 0.95, 0.55),
    Speaker("spk_mid", 150.0, 1.00, 0.70),
    Speaker("spk_high", 205.0, 1.08, 0.85),
    Speaker("spk_top", 260.0, 1.16, 1.00),
)

DEFAULT_SENTENCES: Tuple[str, ...] = (
    "The quick brown fox jumps over the lazy dog.",
    "She sells sea shells by the sea shore.",
    "A big black bug bit a big black bear.",
    "How much wood would a woodchuck chuck?",
    "Pack my box with five dozen liquor jugs.",
    "The rain in Spain stays mainly in the plain.",
    "We promptly judged antique ivory buckles.",
    "Bright vixens jump while the dozy fowl quack.",
    "Good morning, this is a synthetic voice test.",
    "Every token maps to one fixed sound.",
    "Numbers like 42 and 7 are spelled out.",
    "Stop! Who goes there, asked the guard?",
)

# --- Scalable corpus: deterministic sentence/speaker pools -------------------
#
# The generalization study (TRAIN_EVAL.md) varies corpus size while keeping the
# held-out texts FIXED: make_sentences(n) appends generated sentences BEFORE the
# last two defaults, so `--holdout 2` always holds out the same two sentences
# regardless of n and held-out numbers stay comparable across corpus sizes.

_POOL_NOUNS = (
    "table", "river", "garden", "window", "mountain", "basket", "letter",
    "candle", "bridge", "market", "forest", "bottle", "pillow", "hammer",
    "ladder", "meadow", "saddle", "ribbon", "shadow", "silver", "copper",
    "monkey", "rabbit", "farmer", "sailor", "doctor", "painter", "teacher",
    "singer", "winter", "summer", "morning", "evening", "village", "station",
    "engine", "jacket", "pocket", "carpet", "mirror", "branch", "stone",
    "cloud", "storm", "valley", "harbor", "temple", "castle", "wagon", "barrel",
)
_POOL_ADJS = (
    "quiet", "heavy", "gentle", "narrow", "golden", "frozen", "hollow",
    "little", "purple", "simple", "steady", "sudden", "wooden", "yellow",
    "bright", "clever", "distant", "eager", "faithful", "graceful", "humble",
    "modest", "patient", "rugged", "smooth", "sturdy", "tender", "vivid",
)
_POOL_VERBS_PAST = (
    "carried", "folded", "gathered", "lifted", "mended", "opened", "painted",
    "planted", "polished", "pushed", "raised", "repaired", "sorted", "stacked",
    "studied", "traded", "washed", "watched", "weighed", "wrapped", "counted",
    "covered", "crossed", "followed", "guarded", "measured",
)
_POOL_VERBS_PRES = (
    "carries", "folds", "gathers", "lifts", "mends", "opens", "paints",
    "plants", "polishes", "pushes", "raises", "repairs", "sorts", "stacks",
    "studies", "trades", "washes", "watches", "weighs", "wraps", "counts",
)
_POOL_ADVERBS = (
    "slowly", "quickly", "quietly", "carefully", "suddenly", "gladly",
    "rarely", "often", "always", "gently", "firmly", "early",
)
_POOL_PLACES = (
    "near the bridge", "by the river", "under the window", "behind the barn",
    "beside the gate", "over the hill", "along the road", "inside the shed",
    "past the orchard", "across the field",
)


def _pool_sentence(i: int) -> str:
    """Deterministic generated sentence #i (templates x word banks, seeded)."""
    rng = np.random.default_rng(zlib.crc32(f"pool-sentence|{i}".encode()))

    def pick(bank):
        return bank[int(rng.integers(len(bank)))]

    template = int(rng.integers(6))
    n1, n2 = pick(_POOL_NOUNS), pick(_POOL_NOUNS)
    a1, a2 = pick(_POOL_ADJS), pick(_POOL_ADJS)
    vp, vs = pick(_POOL_VERBS_PAST), pick(_POOL_VERBS_PRES)
    adv, place = pick(_POOL_ADVERBS), pick(_POOL_PLACES)
    if template == 0:
        return f"The {a1} {n1} {vs} the {a2} {n2} {place}."
    if template == 1:
        return f"A {a1} {n1} {adv} {vp} the {n2}."
    if template == 2:
        return f"They {vp} the {a1} {n1} and the {a2} {n2}."
    if template == 3:
        return f"The {n1} {place} was {a1} and {a2}."
    if template == 4:
        return f"{adv.capitalize()}, the {a1} {n1} {vs} {place}."
    return f"Every {a1} {n1} {adv} {vs} a {a2} {n2}."


def make_sentences(n: int) -> Tuple[str, ...]:
    """First n sentences of the scalable pool; the LAST TWO defaults stay last
    so a fixed `--holdout 2` split holds out identical texts at every n."""
    if n <= len(DEFAULT_SENTENCES):
        return DEFAULT_SENTENCES[:n]
    extras: List[str] = []
    seen = set(DEFAULT_SENTENCES)
    i = 0
    while len(extras) < n - len(DEFAULT_SENTENCES):
        s = _pool_sentence(i)
        i += 1
        if s in seen:
            continue
        seen.add(s)
        extras.append(s)
    return DEFAULT_SENTENCES[:-2] + tuple(extras) + DEFAULT_SENTENCES[-2:]


def make_speakers(n: int) -> Tuple[Speaker, ...]:
    """First n speakers: the 4 defaults, then deterministic generated voices
    spread over the same F0/formant/tilt ranges (seeded jitter, no collisions)."""
    if n <= len(DEFAULT_SPEAKERS):
        return DEFAULT_SPEAKERS[:n]
    out = list(DEFAULT_SPEAKERS)
    for i in range(n - len(DEFAULT_SPEAKERS)):
        rng = np.random.default_rng(zlib.crc32(f"pool-speaker|{i}".encode()))
        frac = (i + 0.5) / (n - len(DEFAULT_SPEAKERS))
        f0 = 100.0 + 170.0 * frac + float(rng.uniform(-8.0, 8.0))
        scale = 0.93 + 0.25 * frac + float(rng.uniform(-0.02, 0.02))
        tilt = 0.52 + 0.5 * frac + float(rng.uniform(-0.05, 0.05))
        out.append(Speaker(f"spk_gen{i:02d}", round(f0, 1), round(scale, 3), round(tilt, 3)))
    return tuple(out)


def make_unseen_speakers(n: int) -> Tuple[Speaker, ...]:
    """n NEVER-SEEN evaluation voices for the one-shot-cloning study
    (reference capability: cloning from 3-10 s of a voice the model never
    trained on — services/tts/README.md:48-51).

    Drawn from the same F0/formant/tilt ranges as `make_speakers` so they
    interpolate the training speaker space (the honest test: a voice *between*
    training voices, not an out-of-range outlier), but seeded on a disjoint
    key ("unseen-speaker|i" vs "pool-speaker|i") and offset by half a stride,
    so no evaluation voice coincides with a training voice at any training
    speaker count."""
    out: List[Speaker] = []
    for i in range(n):
        rng = np.random.default_rng(zlib.crc32(f"unseen-speaker|{i}".encode()))
        frac = (i + 0.5) / max(n, 1)
        f0 = 105.0 + 165.0 * frac + float(rng.uniform(-10.0, 10.0))
        scale = 0.94 + 0.24 * frac + float(rng.uniform(-0.02, 0.02))
        tilt = 0.55 + 0.45 * frac + float(rng.uniform(-0.05, 0.05))
        out.append(
            Speaker(f"spk_uns{i:02d}", round(f0, 1), round(scale, 3), round(tilt, 3))
        )
    return tuple(out)


def load_corpus_meta(corpus_dir: str) -> Dict:
    """Read the `corpus_meta.json` written by generate_corpus so eval tools
    (tools/eval_checkpoint.py, tools/align_diag.py) recompute ground truth with
    the exact generation parameters — no flag drift between generation and
    grading. Falls back to the 4x12 defaults for corpora generated before the
    meta file existed (they only ever used the defaults)."""
    path = os.path.join(corpus_dir, "corpus_meta.json")
    if not os.path.exists(path):
        return {
            "sentences": list(DEFAULT_SENTENCES),
            "speakers": list(DEFAULT_SPEAKERS),
            "variable": False,
            "rate_variation": False,
            "holdout": 0,
        }
    import json

    with open(path) as f:
        meta = json.load(f)
    return {
        "sentences": list(meta["sentences"]),
        "speakers": [
            Speaker(d["name"], d["f0"], d["formant_scale"], d["tilt"])
            for d in meta["speakers"]
        ],
        "variable": bool(meta.get("variable", False)),
        "rate_variation": bool(meta.get("rate_variation", False)),
        "holdout": int(meta.get("holdout", 0)),
    }


def _band_noise(n: int, sr: int, center: float, bw: float, seed: int) -> np.ndarray:
    """Deterministic band-passed white noise via frequency-domain shaping."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(n).astype(np.float64)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    shape = np.exp(-0.5 * ((freqs - center) / (bw / 2.354)) ** 2)  # FWHM = bw
    out = np.fft.irfft(spec * shape, n)
    rms = np.sqrt((out**2).mean()) + 1e-9
    return (out / rms).astype(np.float32)


def _harmonic_stack(
    n: int, sr: int, f0: float, formants: Sequence[Tuple[float, float]],
    tilt: float, phase_seed: int,
) -> np.ndarray:
    """Sum of harmonics of f0, amplitude-shaped by Gaussian formant envelopes + tilt."""
    t = np.arange(n, dtype=np.float64) / sr
    rng = np.random.default_rng(phase_seed)
    wav = np.zeros(n, np.float64)
    k = 1
    while k * f0 < min(sr / 2 - 200.0, 5000.0):
        f = k * f0
        amp = (f0 / f) ** tilt * (
            sum(np.exp(-0.5 * ((f - f1) / (f1 * 0.18)) ** 2) for f1, _ in formants)
            + 0.35 * sum(np.exp(-0.5 * ((f - f2) / (f2 * 0.14)) ** 2) for _, f2 in formants)
        )
        wav += amp * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        k += 1
    rms = np.sqrt((wav**2).mean()) + 1e-9
    return (wav / rms).astype(np.float32)


def _fade(seg: np.ndarray, sr: int, ms: float = 2.0) -> np.ndarray:
    k = max(1, int(sr * ms / 1000.0))
    env = np.ones(len(seg), np.float32)
    ramp = np.linspace(0.0, 1.0, k, dtype=np.float32)
    env[:k] = ramp
    env[-k:] = ramp[::-1]
    return seg * env


def token_segment(
    symbol: str, speaker: Speaker, f0: float, n: int, sr: int
) -> np.ndarray:
    """Render one token's fixed-length audio segment. Deterministic per
    (symbol, speaker, quantized f0)."""
    if symbol and symbol[-1] in "012":
        symbol = symbol[:-1]  # stress-marked vowels render as their base vowel
    # zlib.crc32 (not hash(): string hashing is per-process randomized) keeps the
    # corpus byte-identical across runs.
    seed = zlib.crc32(f"{symbol}|{speaker.name}".encode())
    if symbol in _VOWEL_FORMANTS or symbol in _SONORANT_FORMANTS:
        f1, f2 = (_VOWEL_FORMANTS.get(symbol) or _SONORANT_FORMANTS[symbol])
        fs = speaker.formant_scale
        seg = 0.30 * _harmonic_stack(
            n, sr, f0, [(f1 * fs, f2 * fs)], speaker.tilt, seed
        )
        if symbol in ("M", "N", "NG"):
            seg *= 0.6  # nasal murmur is quieter
        return _fade(seg, sr)
    if symbol in _NOISE_RECIPES:
        center, bw, amp, voiced = _NOISE_RECIPES[symbol]
        seg = amp * _band_noise(n, sr, center * speaker.formant_scale, bw, seed)
        if voiced:
            seg = 0.6 * seg + 0.12 * _harmonic_stack(
                n, sr, f0, [(500.0 * speaker.formant_scale, 1200.0)], speaker.tilt, seed
            )
        return _fade(seg, sr)
    if symbol in _STOP_RECIPES:
        center, amp, voiced = _STOP_RECIPES[symbol]
        seg = np.zeros(n, np.float32)
        burst = amp * _band_noise(n // 4, sr, center * speaker.formant_scale, 1500.0, seed)
        seg[: n // 4] = burst
        if voiced:
            seg += 0.1 * _harmonic_stack(
                n, sr, f0, [(350.0 * speaker.formant_scale, 900.0)], speaker.tilt, seed
            )
        return _fade(seg, sr)
    # PAD/BOS/EOS/<sp>/punctuation → near-silence (tiny dither keeps DSP happy).
    rng = np.random.default_rng(seed)
    return (1e-4 * rng.standard_normal(n)).astype(np.float32)


def is_silence_symbol(symbol: str) -> bool:
    """True for tokens the corpus renders as (near-)silence: <sp>, punctuation,
    BOS/EOS/PAD. Splits BETWEEN adjacent silence tokens are acoustically
    unobservable, so alignment evals report silence-excluded metrics alongside
    the overall ones (tools/align_diag.py, tools/eval_checkpoint.py)."""
    if symbol and symbol[-1] in "012":
        symbol = symbol[:-1]
    return not (
        symbol in _VOWEL_FORMANTS or symbol in _SONORANT_FORMANTS
        or symbol in _NOISE_RECIPES or symbol in _STOP_RECIPES
    )


def rate_for_text(text: str) -> float:
    """Deterministic per-sentence speaking-rate multiplier in [0.75, 1.30].

    Keyed on the sentence text alone, so any tool can recompute it; NOT derivable
    from linguistic features, so it stresses the MAS aligner (which sees the audio
    and must recover it) rather than the duration predictor (which cannot)."""
    return 0.75 + 0.55 * (zlib.crc32(f"rate|{text}".encode()) % 1024) / 1023.0


def utterance_durations(
    ids: Sequence[int], text: str, rate_variation: bool = False,
    jitter_salt: str = "",
) -> List[int]:
    """Deterministic VARIABLE per-token frame counts (mean ≈ FRAMES_PER_TOKEN).

    Class-dependent base + seeded jitter keyed on (symbol, position, text) — so the
    mapping is learnable (phone identity and position drive length) but NOT uniform:
    a model that merely spreads frames evenly gets the alignment measurably wrong,
    which is exactly what the aligner-learning eval needs to detect.
    rate_variation=True additionally scales the whole sentence by `rate_for_text`
    (the harder-corpus mode: global tempo the aligner must absorb per utterance).
    jitter_salt perturbs ONLY the jitter key (not the token ids or rate): it
    yields an alternative iid realization of the same utterance — the basis of
    tools/jitter_floor.py's irreducible-error floor on unseen text."""
    rate = rate_for_text(text) if rate_variation else 1.0
    out = []
    for pos, tok in enumerate(ids):
        sym = SYMBOLS[tok]
        if sym and sym[-1] in "012":
            sym = sym[:-1]  # stress marks don't change the segment class
        jitter = zlib.crc32(f"{sym}|{pos}|{text}{jitter_salt}".encode())
        if sym in _VOWEL_FORMANTS:
            dur = 4 + jitter % 4  # 4-7: vowels longest
        elif sym in _SONORANT_FORMANTS:
            dur = 3 + jitter % 3  # 3-5
        elif sym in _NOISE_RECIPES:
            dur = 3 + jitter % 2  # 3-4
        elif sym in _STOP_RECIPES:
            dur = 2 + jitter % 2  # 2-3
        else:
            dur = 2 + jitter % 4  # 2-5: silence/punctuation varies most
        out.append(max(1, int(round(dur * rate))))
    return out


def synthesize_utterance(
    text: str, speaker: Speaker, cfg: ModelConfig, variable: bool = False,
    rate_variation: bool = False, jitter_salt: str = "",
    durations: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Text → (waveform, token ids); FRAMES_PER_TOKEN frames per token, or the
    deterministic `utterance_durations` spread when variable=True. `durations`
    overrides both (tools/jitter_floor.py's expected-duration rendition)."""
    ids = text_to_ids(text)
    if durations is not None:
        durs = list(durations)
    else:
        durs = (
            utterance_durations(
                ids, text, rate_variation=rate_variation, jitter_salt=jitter_salt
            )
            if variable
            else [FRAMES_PER_TOKEN] * len(ids)
        )
    segs = []
    n_tok = len(ids)
    for pos, (tok, d) in enumerate(zip(ids, durs)):
        # Sentence-level declination: ~ +6% at start → -8% at end.
        frac = pos / max(n_tok - 1, 1)
        f0 = speaker.f0 * (1.06 - 0.14 * frac)
        segs.append(
            token_segment(SYMBOLS[tok], speaker, f0, d * cfg.hop_length, cfg.sample_rate)
        )
    return np.concatenate(segs), ids


def generate_corpus(
    out_dir: str,
    cfg: Optional[ModelConfig] = None,
    sentences: Sequence[str] = DEFAULT_SENTENCES,
    speakers: Sequence[Speaker] = DEFAULT_SPEAKERS,
    variable: bool = False,
    holdout: int = 0,
    rate_variation: bool = False,
) -> str:
    """Write WAVs + manifest + per-speaker reference clips; returns manifest path.

    variable=True renders `utterance_durations` per token (non-uniform; the corpus
    for alignment-learning runs). holdout=N additionally writes
    manifest_train.txt / manifest_heldout.txt with the LAST N sentences of every
    speaker held out — the generalization split the training eval reports.
    rate_variation=True adds the per-sentence tempo multiplier (`rate_for_text`).

    Writes `corpus_meta.json` describing the generation parameters so eval tools
    (tools/eval_checkpoint.py, tools/align_diag.py) recompute ground truth without
    flag drift."""
    cfg = cfg or ModelConfig()
    os.makedirs(out_dir, exist_ok=True)
    for text in sentences:
        if "|" in text:
            # '|' is the manifest field separator; writing it through would
            # silently mis-split the train/holdout partition and then fail
            # load_manifest with a confusing unrecognized-field error.
            raise ValueError(f"sentence text must not contain '|': {text!r}")
    lines = []
    heldout_texts = set(sentences[-holdout:]) if holdout > 0 else set()
    # Reference-clip sentences must come from the TRAIN side: the ref WAV
    # conditions every training example, so embedding a held-out sentence's
    # audio in it would contaminate the generalization eval.
    train_idx = [i for i, t in enumerate(sentences) if t not in heldout_texts]
    if len(train_idx) < 1:
        raise ValueError("holdout leaves no training sentences for the ref clip")
    ref_idx = (train_idx[0], train_idx[len(train_idx) // 2])
    for spk in speakers:
        # Reference clip (two concatenated sentences, >3 s): the per-speaker
        # conditioning audio for BOTH training (`ref=` manifest column) and cloning
        # eval — the model must key on this fixed embedding, exactly as serving does.
        ref = np.concatenate(
            [
                synthesize_utterance(sentences[j], spk, cfg, variable, rate_variation)[0]
                for j in ref_idx
            ]
        )
        ref_path = os.path.join(out_dir, f"ref_{spk.name}.wav")
        write_wav(ref_path, ref, cfg.sample_rate)
        for i, text in enumerate(sentences):
            wav, _ = synthesize_utterance(text, spk, cfg, variable, rate_variation)
            path = os.path.join(out_dir, f"{spk.name}_{i:02d}.wav")
            write_wav(path, wav, cfg.sample_rate)
            lines.append(f"{path}|{text}|ref={ref_path}")
    manifest = os.path.join(out_dir, "manifest.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    import json

    with open(os.path.join(out_dir, "corpus_meta.json"), "w") as f:
        json.dump(
            {
                "variable": variable,
                "rate_variation": rate_variation,
                "holdout": holdout,
                "sentences": list(sentences),
                "speakers": [
                    {"name": s.name, "f0": s.f0, "formant_scale": s.formant_scale,
                     "tilt": s.tilt}
                    for s in speakers
                ],
            },
            f, indent=1,
        )
    if holdout > 0:
        train_lines = [ln for ln in lines if ln.split("|")[1] not in heldout_texts]
        held_lines = [ln for ln in lines if ln.split("|")[1] in heldout_texts]
        with open(os.path.join(out_dir, "manifest_train.txt"), "w") as f:
            f.write("\n".join(train_lines) + "\n")
        with open(os.path.join(out_dir, "manifest_heldout.txt"), "w") as f:
            f.write("\n".join(held_lines) + "\n")
    return manifest


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="generate the deterministic formant corpus")
    ap.add_argument("--out-dir", default="corpus")
    ap.add_argument("--variable", action="store_true",
                    help="non-uniform per-token durations (alignment-learning corpus)")
    ap.add_argument("--holdout", type=int, default=0,
                    help="hold out the last N sentences per speaker into manifest_heldout.txt")
    ap.add_argument("--sentences", type=int, default=len(DEFAULT_SENTENCES),
                    help="corpus size: first N of the deterministic sentence pool "
                         "(>12 appends generated sentences; the held-out texts stay fixed)")
    ap.add_argument("--speakers", type=int, default=len(DEFAULT_SPEAKERS),
                    help="number of speakers (>4 appends generated voices)")
    ap.add_argument("--rate-variation", action="store_true",
                    help="per-sentence speaking-rate multiplier (harder aligner corpus)")
    args = ap.parse_args()
    manifest = generate_corpus(
        args.out_dir,
        sentences=make_sentences(args.sentences),
        speakers=make_speakers(args.speakers),
        variable=args.variable,
        holdout=args.holdout,
        rate_variation=args.rate_variation,
    )
    print(manifest)


if __name__ == "__main__":
    main()
