"""Training data pipeline: manifest-driven supervised batches with static shapes.

Counterpart of `gonova_tts_tpu/train/data.py`:

  manifest line:  <wav_path>|<text>[|<durations>][|ref=<ref_wav_path>]
  → text frontend (normalize → G2P → token ids, bucket-padded)
  → DSP (resample to model rate, log-mel, frame-wise F0 targets)
  → uniform duration targets (total mel frames spread over tokens), or an
    external aligner's durations (a third |-separated field of space-joined ints),
    or none with learn_alignment (the MAS aligner extracts them in the step)
  → speaker conditioning: the `ref=` clip's mel for the in-step speaker encoder
    (ref_mel=True), or a fixed embedding from `speaker_fn`.

The arrays are numpy, built on the host; the log-mels are the port's plain
`audio.mel.mel_spectrogram` on CPU tensors. Batches are (token-bucket, frame-cap)
static, the serving engine's bucketing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..audio.mel import mel_spectrogram
from ..audio.pitch import estimate_f0, f0_to_feature
from ..audio.resample import resample_np
from ..config import ModelConfig
from ..text import pick_bucket, text_to_ids
from ..utils import read_wav


def _host(wav: np.ndarray) -> torch.Tensor:
    """[1, T] f32 CPU tensor: data preparation runs on the host."""
    return torch.as_tensor(np.asarray(wav, np.float32))[None]


@dataclass
class Example:
    tokens: np.ndarray  # [L] int32
    mel: np.ndarray  # [T, n_mels] f32
    pitch_frames: np.ndarray  # [T] f32 (log-pitch feature per frame)
    audio: np.ndarray  # [T * hop] f32
    speaker: Optional[np.ndarray] = None  # [speaker_dim] f32 (None → zeros)
    ref_mel: Optional[np.ndarray] = None  # [T_ref, n_mels] reference-clip mel
    ref_frames: int = 0  # valid frames in ref_mel
    durations: Optional[np.ndarray] = None  # [L] int32 external-aligner durations
    # Short-window mel for the MAS aligner (win = hop: zero cross-frame overlap).
    # The synthesis mel's 1024-sample analysis window spans +-2 hops, so every
    # boundary frame mixes both neighbors' audio and MAS hands blur frames to the
    # louder class (measured: fricatives +1.04 frames, silence -1.12, dur_corr
    # capped ~0.65 on the variable-duration corpus). Alignment needs temporal
    # resolution, synthesis needs spectral smoothness — two different features.
    align_mel: Optional[np.ndarray] = None  # [T, n_mels] f32


def load_manifest(path: str) -> List[Dict[str, str]]:
    import re

    entries = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw or raw.startswith("#"):
                continue
            parts = raw.split("|")
            if len(parts) < 2:
                raise ValueError(f"manifest line needs '<wav>|<text>': {raw!r}")
            entry = {"wav": parts[0], "text": parts[1]}
            for extra in parts[2:]:
                extra = extra.strip()
                if not extra:
                    continue
                if extra.startswith("ref="):
                    entry["ref"] = extra[4:]
                elif re.fullmatch(r"\d+(?:\s+\d+)*", extra):
                    # Space-joined integer durations — the ONLY other field shape.
                    # Anything else must fail here with a line number, not as a
                    # confusing int() crash later (and a typo'd field must never be
                    # silently consumed as durations, which would also flip the
                    # run out of learned-alignment mode).
                    entry["durations"] = extra
                else:
                    raise ValueError(
                        f"{path}:{lineno}: unrecognized manifest field {extra!r} "
                        "(expected 'ref=<wav_path>' or space-separated integer "
                        "durations)"
                    )
            entries.append(entry)
    return entries


def prepare_example(
    wav_path: str,
    text: str,
    cfg: ModelConfig,
    speaker_fn=None,
    ref_path=None,
    ref_mel: bool = False,
    durations: Optional[str] = None,
    align_features: bool = False,
) -> Example:
    """Speaker conditioning, two modes:

    * ref_mel=True (cloning training, preferred): store the `ref_path` clip's mel
      features; the train step embeds them IN-GRAPH so the speaker encoder is
      trained jointly and learns to separate voices. (A frozen random encoder maps
      all voices to nearly one point — measured cross-speaker cosine 0.99 — so the
      model amplifies noise instead of identity and cloning never generalizes.)
    * speaker_fn (fixed external embedder): precomputed embedding, no encoder grads.
    """
    audio, sr = read_wav(wav_path)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    wav = resample_np(np.asarray(audio, np.float32), sr, cfg.sample_rate)
    wav = wav[: len(wav) - len(wav) % cfg.hop_length]
    mel = np.asarray(
        mel_spectrogram(
            _host(wav),
            sr=cfg.sample_rate,
            n_fft=cfg.n_fft,
            hop_length=cfg.hop_length,
            win_length=cfg.win_length,
            n_mels=cfg.n_mels,
            fmin=cfg.fmin,
            fmax=cfg.fmax,
        )[0]
    )
    amel = None
    if align_features:
        # win = hop: each aligner frame sees ONLY its own hop of audio (see the
        # Example.align_mel comment). n_fft = hop keeps the bin count minimal.
        amel = np.asarray(
            mel_spectrogram(
                _host(wav),
                sr=cfg.sample_rate,
                n_fft=cfg.hop_length,
                hop_length=cfg.hop_length,
                win_length=cfg.hop_length,
                n_mels=cfg.n_mels,
                fmin=cfg.fmin,
                fmax=cfg.fmax,
            )[0],
            np.float32,
        )
    f0 = estimate_f0(wav, cfg.sample_rate, cfg.hop_length, cfg.n_fft)
    tokens = np.asarray(text_to_ids(text), np.int32)
    speaker = None
    rmel, rframes = None, 0
    if ref_mel:
        if ref_path:
            ref_audio, ref_sr = read_wav(ref_path)
        else:
            ref_audio, ref_sr = wav, cfg.sample_rate
        rmel, rframes = ref_mel_features(np.asarray(ref_audio, np.float32), ref_sr, cfg)
    elif speaker_fn is not None:
        if ref_path:
            ref_audio, ref_sr = read_wav(ref_path)
            if ref_audio.ndim > 1:
                ref_audio = ref_audio.mean(axis=1)
            speaker = np.asarray(
                speaker_fn(np.asarray(ref_audio, np.float32), ref_sr), np.float32
            )
        else:
            speaker = np.asarray(speaker_fn(wav, cfg.sample_rate), np.float32)
    dur = None
    if durations:
        dur = np.asarray([int(d) for d in str(durations).split()], np.int32)
        if len(dur) != len(tokens):
            raise ValueError(
                f"{wav_path}: manifest durations length {len(dur)} != {len(tokens)} tokens"
            )
    return Example(
        tokens=tokens,
        mel=mel.astype(np.float32),
        pitch_frames=f0_to_feature(f0),
        audio=wav.astype(np.float32),
        speaker=speaker,
        ref_mel=rmel,
        ref_frames=rframes,
        durations=dur,
        align_mel=amel,
    )


def ref_mel_features(audio: np.ndarray, sr: int, cfg: ModelConfig):
    """Reference-clip log-mel at the engine's static 10 s analysis length.

    Returns (mel [T_ref, n_mels], n_valid_frames). Mirrors engine.embed_voice's
    buffer/mask convention exactly so the speaker encoder sees identical inputs in
    training (in-graph, gradients flowing) and serving (cloning a registered voice)."""
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    wav = resample_np(np.asarray(audio, np.float32), sr, cfg.sample_rate)
    max_samples = int(10.0 * cfg.sample_rate)
    max_samples -= max_samples % cfg.hop_length
    n = min(len(wav), max_samples)
    buf = np.zeros((max_samples,), np.float32)
    buf[:n] = wav[:n]
    mel = np.asarray(
        mel_spectrogram(
            _host(buf), sr=cfg.sample_rate, n_fft=cfg.n_fft,
            hop_length=cfg.hop_length, win_length=cfg.win_length,
            n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax,
        )[0]
    ).astype(np.float32)
    return mel, n // cfg.hop_length


_SILENCE_MEL_CACHE: Dict[tuple, np.ndarray] = {}


def silence_mel(cfg: ModelConfig) -> np.ndarray:
    """The log-mel vector of digital silence [n_mels].

    Batch mel padding uses this (not 0.0): zero log-mel reads as moderate energy to
    the vocoder, so zero-padding would teach it to synthesize noise after utterance
    end. Padding with the true silence encoding makes 'silence mel → silent audio'
    a consistent, learnable mapping on the padded region too."""
    key = (cfg.sample_rate, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.n_mels,
           cfg.fmin, cfg.fmax)
    if key not in _SILENCE_MEL_CACHE:
        zeros = torch.zeros((1, cfg.n_fft * 4), dtype=torch.float32)
        m = np.asarray(
            mel_spectrogram(
                zeros, sr=cfg.sample_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                win_length=cfg.win_length, n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax,
            )[0]
        )
        _SILENCE_MEL_CACHE[key] = m[m.shape[0] // 2].astype(np.float32)
    return _SILENCE_MEL_CACHE[key]


def _uniform_durations(n_tokens: int, n_frames: int, cap: int) -> np.ndarray:
    """Spread min(n_frames, n_tokens*cap) over n_tokens as evenly as possible.

    Sums EXACTLY to that total (the collate slices mel/audio by the sum, so an
    overshoot crashes on short clips); entries may be 0 when there are fewer
    frames than tokens — inference clamps durations >= 1, training targets don't
    need to."""
    total = min(n_frames, n_tokens * cap)
    base = total // max(n_tokens, 1)
    dur = np.full((n_tokens,), base, np.int32)
    dur[: total - base * n_tokens] += 1
    return np.clip(dur, 0, cap)


def make_batch(
    examples: Sequence[Example],
    cfg: ModelConfig,
    token_buckets: Sequence[int] = (32, 64, 128, 192),
    learn_alignment: bool = False,
) -> Dict[str, np.ndarray]:
    """Collate examples into one static-shape supervised batch (train/step.py keys).

    learn_alignment=True: no duration targets are fabricated — the full mel/audio is
    packed (durations stay 0, ignored by the step), and frame-level pitch ships as
    `pitch_frames` for in-graph per-token pooling under the MAS segmentation."""
    b = len(examples)
    longest = max(len(e.tokens) for e in examples)
    bucket = pick_bucket(longest, token_buckets)
    t_cap = bucket * cfg.max_frames_per_token
    hop = cfg.hop_length
    spk_dim = cfg.speaker_dim

    batch = {
        "tokens": np.zeros((b, bucket), np.int32),
        "token_mask": np.zeros((b, bucket), np.float32),
        "speaker": np.zeros((b, spk_dim), np.float32),
        "exaggeration": np.full((b,), 0.5, np.float32),
        "durations": np.zeros((b, bucket), np.int32),
        "pitch": np.zeros((b, bucket), np.float32),
        "mel": np.tile(silence_mel(cfg), (b, t_cap, 1)),
        "frame_mask": np.zeros((b, t_cap), np.float32),
        "audio": np.zeros((b, t_cap * hop), np.float32),
    }
    if any(e.ref_mel is not None for e in examples):
        t_ref = max(e.ref_mel.shape[0] for e in examples if e.ref_mel is not None)
        batch["ref_mel"] = np.tile(silence_mel(cfg), (b, t_ref, 1))
        batch["ref_mask"] = np.zeros((b, t_ref), np.float32)
    if learn_alignment:
        batch["pitch_frames"] = np.zeros((b, t_cap), np.float32)
        # Only when every example carries the short-window feature (ManifestDataset
        # does; direct make_batch callers without it fall back to the synthesis mel
        # in the train step). log(eps) silence floor for padded frames.
        if all(e.align_mel is not None for e in examples):
            batch["align_mel"] = np.full(
                (b, t_cap, cfg.n_mels), np.log(1e-5), np.float32
            )

    for i, e in enumerate(examples):
        l = min(len(e.tokens), bucket)
        t = min(e.mel.shape[0], t_cap)
        batch["tokens"][i, :l] = e.tokens[:l]
        batch["token_mask"][i, :l] = 1.0
        if e.speaker is not None:
            batch["speaker"][i] = e.speaker[:spk_dim]
        if e.ref_mel is not None:
            tr = e.ref_mel.shape[0]
            batch["ref_mel"][i, :tr] = e.ref_mel
            batch["ref_mask"][i, : e.ref_frames] = 1.0
        if learn_alignment:
            # MAS extracts the text↔frame map in-graph; a monotonic path needs at
            # least one frame per token.
            if t < l:
                raise ValueError(
                    f"alignment learning needs >= 1 frame per token "
                    f"({t} frames < {l} tokens)"
                )
            if e.mel.shape[0] > t_cap:
                # Truncating audio while keeping all tokens would silently corrupt
                # every MAS duration target for this utterance (text whose audio
                # was cut gets crammed into the remaining frames). Fail loud like
                # the short side above.
                raise ValueError(
                    f"utterance has {e.mel.shape[0]} frames but the bucket caps at "
                    f"{t_cap} (= bucket {bucket} x max_frames_per_token "
                    f"{cfg.max_frames_per_token}); split the utterance or raise "
                    "max_frames_per_token — truncation would corrupt alignment "
                    "targets"
                )
            batch["mel"][i, :t] = e.mel[:t]
            batch["frame_mask"][i, :t] = 1.0
            batch["audio"][i, : t * hop] = e.audio[: t * hop]
            batch["pitch_frames"][i, :t] = e.pitch_frames[:t]
            if "align_mel" in batch:
                batch["align_mel"][i, :t] = e.align_mel[:t]
            continue
        if e.durations is not None:
            # External-aligner targets: clip per-token to the cap and truncate the
            # tail so the cumulative sum never exceeds the available frames.
            dur = np.clip(e.durations[:l], 0, cfg.max_frames_per_token)
            over = dur.sum() - t
            j = l - 1
            while over > 0 and j >= 0:
                take = min(int(dur[j]), int(over))
                dur[j] -= take
                over -= take
                j -= 1
        else:
            dur = _uniform_durations(l, t, cfg.max_frames_per_token)
        batch["durations"][i, :l] = dur
        t_used = int(dur.sum())
        batch["mel"][i, :t_used] = e.mel[:t_used]
        batch["frame_mask"][i, :t_used] = 1.0
        batch["audio"][i, : t_used * hop] = e.audio[: t_used * hop]
        # Per-token pitch target = mean frame pitch over the token's span.
        bounds = np.concatenate([[0], np.cumsum(dur)])
        pf = e.pitch_frames[:t_used]
        for j in range(l):
            seg = pf[bounds[j] : bounds[j + 1]]
            batch["pitch"][i, j] = float(seg.mean()) if len(seg) else 0.0
    return batch


class ManifestDataset:
    """Iterates manifest examples as bucketed batches; shuffles per epoch."""

    def __init__(
        self,
        manifest_path: str,
        cfg: ModelConfig,
        batch_size: int = 8,
        token_buckets: Sequence[int] = (32, 64, 128, 192),
        seed: int = 0,
        cache: bool = True,
        speaker_fn=None,
        ref_mel: bool = False,
        learn_alignment: bool = False,
        entries: Optional[List[Dict[str, str]]] = None,
    ):
        # `entries` lets a caller that already parsed the manifest (the train
        # loop's alignment auto-detect / bucket sizing) avoid a re-read.
        self.entries = entries if entries is not None else load_manifest(manifest_path)
        if not self.entries:
            raise ValueError(f"empty manifest: {manifest_path}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.token_buckets = tuple(token_buckets)
        self.seed = seed
        self.speaker_fn = speaker_fn
        self.ref_mel = ref_mel
        self.learn_alignment = learn_alignment
        self._cache: Optional[List[Example]] = [] if cache else None

    def _examples(self) -> List[Example]:
        if self._cache:
            return self._cache
        examples = [
            prepare_example(
                e["wav"], e["text"], self.cfg,
                speaker_fn=self.speaker_fn, ref_path=e.get("ref"),
                ref_mel=self.ref_mel, durations=e.get("durations"),
                align_features=self.learn_alignment,
            )
            for e in self.entries
        ]
        if self._cache is not None:
            self._cache = examples
        return examples

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        examples = self._examples()
        order = np.random.default_rng(self.seed + epoch_idx).permutation(len(examples))
        # Group by bucket so batches stay shape-uniform.
        by_bucket: Dict[int, List[Example]] = {}
        for idx in order:
            e = examples[idx]
            b = pick_bucket(len(e.tokens), self.token_buckets)
            by_bucket.setdefault(b, []).append(e)
        for bucket_examples in by_bucket.values():
            for i in range(0, len(bucket_examples), self.batch_size):
                group = bucket_examples[i : i + self.batch_size]
                n_real = len(group)
                while len(group) < self.batch_size:
                    group.append(group[-1])
                batch = make_batch(
                    group, self.cfg, self.token_buckets,
                    learn_alignment=self.learn_alignment,
                )
                # Pad rows must contribute ZERO loss — repeating the last example
                # as live rows would weight it n_pad+1 times per epoch (a real
                # sampling bias on the small corpora this loader targets).
                if n_real < self.batch_size:
                    for key in ("token_mask", "frame_mask", "durations", "pitch", "audio"):
                        batch[key][n_real:] = 0
                    if "pitch_frames" in batch:
                        batch["pitch_frames"][n_real:] = 0
                    # The multi-res STFT and GAN losses are NOT masked: pad rows
                    # must carry silence mel to match their zero audio, or they'd
                    # actively teach vocode(real mel) -> silence.
                    batch["mel"][n_real:] = silence_mel(self.cfg)[None, None, :]
                    if "ref_mask" in batch:
                        batch["ref_mask"][n_real:] = 0
                yield batch
