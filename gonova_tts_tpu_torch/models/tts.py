"""The combined TTS pipeline: acoustic model + vocoder + speaker encoder.

Counterpart of `gonova_tts_tpu/models/tts.py`. `synthesize` is tokens → mel →
waveform in one pass; `encode_acoustic` / `decode_vocode` are the engine's
two-stage halves; `acoustic_mel` and `vocode` are the streaming stages;
`embed_speaker` is the voice-cloning stage (reference log-mel → embedding).
The vocoder is NovaVocos (`vocoder_family="vocos"`), the HiFi-GAN generator
(`"hifigan"`, served in the lane-folded layout unless `hifigan_folded` is off) or
BigVGAN-v2's generator (`"bigvgan"`). With `acoustic_family="f5"` the acoustic
model is F5-TTS's DiT (`models/f5.py`), which clones from a transcribed prompt and
has no speaker encoder; its pass is `f5.sample`, then `vocode` over the generated
frames.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..config import ModelConfig
from . import acoustic, aligner, bigvgan, f5, speaker, vocoder, vocoder_folded, vocos
from .layers import Tree


def _vocoder_mod(cfg: ModelConfig):
    if cfg.vocoder_family == "vocos":
        return vocos
    if cfg.vocoder_family == "hifigan":
        return vocoder
    if cfg.vocoder_family == "bigvgan":
        return bigvgan
    raise ValueError(f"unknown vocoder_family {cfg.vocoder_family!r}")


def hifigan_forward_fn(cfg: ModelConfig):
    """The one routing rule between the folded and the plain HiFi-GAN layout, for
    both the pipeline (`_vocoder_forward`) and the registry's `novagan` family."""
    return vocoder_folded.forward if cfg.hifigan_folded else vocoder.forward


def _vocoder_forward(cfg: ModelConfig):
    """Forward function of the configured vocoder family."""
    if cfg.vocoder_family == "hifigan":
        return hifigan_forward_fn(cfg)
    return _vocoder_mod(cfg).forward


class TTS(Tree):
    """`{"acoustic", "vocoder", "speaker"}` — the JAX parameter tree as one module.
    A fresh one is seeded from `g` (defaults to seed 0). `with_aligner=True` adds
    the MAS aligner subtree (`models/aligner.py`), which training from raw (text,
    audio) pairs needs and serving never runs. An F5 model (`acoustic_family`
    "f5") is `{"acoustic": the DiT, "vocoder"}`."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator] = None, with_aligner: bool = False):
        super().__init__()
        if g is None:
            g = torch.Generator().manual_seed(0)
        self.cfg = cfg
        if cfg.acoustic_family == "f5":
            self.acoustic = f5.init(g, cfg)
            self.vocoder = _vocoder_mod(cfg).init(g, cfg)
            return
        self.acoustic = acoustic.AcousticModel(cfg, g)
        self.vocoder = _vocoder_mod(cfg).init(g, cfg)
        self.speaker = speaker.init(g, cfg)
        if with_aligner:
            self.aligner = aligner.init(g, cfg)

    def forward(self, tokens, token_mask, spk_embedding, exaggeration, dtype=torch.float32):
        return synthesize(self, tokens, token_mask, spk_embedding, exaggeration, self.cfg, dtype)


def _with_audio(wav: torch.Tensor, total_frames: torch.Tensor, hop: int) -> Dict[str, torch.Tensor]:
    total_samples = total_frames * hop
    sample_mask = torch.arange(wav.shape[-1], device=wav.device)[None, :] < total_samples[:, None]
    return {
        "audio": wav * sample_mask.to(wav.dtype),
        "sample_mask": sample_mask,
        "total_samples": total_samples,
    }


def synthesize(
    params: Mapping,
    tokens: torch.Tensor,  # [B, L] int
    token_mask: torch.Tensor,  # [B, L]
    spk_embedding: torch.Tensor,  # [B, speaker_dim]
    exaggeration: torch.Tensor,  # [B]
    cfg: ModelConfig,
    dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    """Full pipeline. Returns audio [B, T_frames * hop], sample mask, mel, frames."""
    ac = acoustic.forward(params["acoustic"], tokens, token_mask, spk_embedding, exaggeration, cfg, dtype=dtype)
    wav = _vocoder_forward(cfg)(params["vocoder"], ac["mel"], cfg, dtype=dtype)
    out = _with_audio(wav, ac["total_frames"], cfg.hop_length)
    out.update(
        mel=ac["mel"], frame_mask=ac["frame_mask"], total_frames=ac["total_frames"],
        durations=ac["durations"],
    )
    return out


def reach_frames(cfg: ModelConfig) -> int:
    """Mel frames each side that one sample of the configured vocoder can depend on:
    the context a streamed window needs, and the zero frames a two-stage pass keeps
    past a batch's longest sentence, for the audio to equal the one-shot pass's."""
    return _vocoder_mod(cfg).reach_frames(cfg)


def vocode(params: Mapping, mel: torch.Tensor, cfg: ModelConfig, dtype=torch.float32) -> torch.Tensor:
    return _vocoder_forward(cfg)(params["vocoder"], mel, cfg, dtype=dtype)


def embed_speaker(
    params: Mapping, mel: torch.Tensor, frame_mask: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """Reference mel → speaker embedding [B, speaker_dim]."""
    return speaker.forward(params["speaker"], mel, frame_mask, dtype=dtype)


def encode_acoustic(
    params: Mapping, tokens, token_mask, spk_embedding, exaggeration, cfg: ModelConfig,
    dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    """Token-domain half (acoustic.encode)."""
    return acoustic.encode(params["acoustic"], tokens, token_mask, spk_embedding, exaggeration, cfg, dtype=dtype)


def decode_vocode(
    params: Mapping,
    enc: torch.Tensor,  # [B, L, D] from encode_acoustic
    spk: torch.Tensor,  # [B, D] from encode_acoustic
    durations: torch.Tensor,  # [B, L] from encode_acoustic
    token_mask: torch.Tensor,  # [B, L]
    max_frames: int,
    cfg: ModelConfig,
    dtype=torch.float32,
    local_attention_from: int = 0,
) -> Dict[str, torch.Tensor]:
    """Frame-domain half: length regulate + decoder + vocoder at `max_frames`.
    Audio below each sequence's total_samples matches `synthesize` whenever
    max_frames covers the batch and local_attention_from is the one-shot
    frame count."""
    d = acoustic.decode(
        params["acoustic"], enc, spk, durations, token_mask, max_frames, cfg,
        dtype=dtype, local_attention_from=local_attention_from or None,
    )
    wav = _vocoder_forward(cfg)(params["vocoder"], d["mel"], cfg, dtype=dtype)
    out = _with_audio(wav, d["total_frames"], cfg.hop_length)
    del out["sample_mask"]
    out["total_frames"] = d["total_frames"]
    return out


def acoustic_mel(
    params: Mapping, tokens, token_mask, spk_embedding, exaggeration, cfg: ModelConfig,
    dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    """Acoustic stage only (streaming: mel first, then windowed vocode)."""
    return acoustic.forward(params["acoustic"], tokens, token_mask, spk_embedding, exaggeration, cfg, dtype=dtype)
