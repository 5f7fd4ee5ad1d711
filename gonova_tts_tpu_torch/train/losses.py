"""Training losses: acoustic (mel/duration/pitch), vocoder (multi-res STFT + GAN).

Counterpart of `gonova_tts_tpu/train/losses.py`: the FastPitch + HiFi-GAN
objectives as plain functions on tensors, differentiable under autograd. The
multi-resolution STFT loss is also the vocoder term of the bf16 parity gate
(`parity_gpu.py`). The mel-reconstruction loss takes the plain log-mel
(`audio.mel.mel_spectrogram`), never the fused mel kernel, which has no backward.

Every sum, mean and norm over the batch goes through `tp.global_sum`: under a
'data' group (`tp.data_parallel`, the sharded steps) each rank holds a block of
the batch's rows, and a masked mean divides by the global denominator (the mask
sums all-reduced first, the clamp applied to the global sum), so every rank
computes the loss of the whole batch, as the JAX package's sharded step does. A
mean of per-shard means would be another loss once the masks differ between
shards. Without a group these are the one-device losses.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..audio.mel import mel_spectrogram
from ..audio.stft import spectrogram
from ..parallel.tp import global_mean, global_sum


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - target| over valid frames. mask: [B, T], inputs [B, T, C]."""
    m = mask[..., None]
    denom = torch.clamp(global_sum(m.sum()) * pred.shape[-1], min=1.0)
    return global_sum((torch.abs(pred - target) * m).sum()) / denom


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp(global_sum(mask.sum()), min=1.0)
    return global_sum((((pred - target) ** 2) * mask).sum()) / denom


def duration_loss(log_dur_pred: torch.Tensor, dur_target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE in log domain (FastSpeech convention: target = log(d + 1))."""
    target = torch.log(dur_target.float() + 1.0)
    return masked_mse(log_dur_pred, target, mask)


def acoustic_loss(
    outputs: Dict[str, torch.Tensor],
    mel_target: torch.Tensor,
    dur_target: torch.Tensor,
    pitch_target: torch.Tensor,
    token_mask: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    l_mel = masked_l1(outputs["mel"], mel_target, outputs["frame_mask"])
    l_dur = duration_loss(outputs["log_durations"], dur_target, token_mask)
    l_pitch = masked_mse(outputs["pitch"], pitch_target, token_mask)
    total = l_mel + 0.1 * l_dur + 0.1 * l_pitch
    return total, {"mel": l_mel, "dur": l_dur, "pitch": l_pitch}


# ---------------------------------------------------------------- vocoder losses

_MRSTFT_CONFIGS: Sequence[Tuple[int, int, int]] = ((512, 128, 512), (1024, 256, 1024), (2048, 512, 2048))


def multi_resolution_stft_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum of spectral-convergence + log-magnitude L1 over three STFT resolutions."""
    total = 0.0
    for n_fft, hop, win in _MRSTFT_CONFIGS:
        sp = spectrogram(pred, n_fft, hop, win)
        st = spectrogram(target, n_fft, hop, win)
        sc = torch.sqrt(global_sum(((st - sp) ** 2).sum())) / torch.clamp(
            torch.sqrt(global_sum((st * st).sum())), min=1e-6
        )
        lm = global_mean(torch.abs(torch.log(torch.clamp(sp, min=1e-5)) - torch.log(torch.clamp(st, min=1e-5))))
        total = total + sc + lm
    return total / len(_MRSTFT_CONFIGS)


def mel_reconstruction_loss(
    wav_pred: torch.Tensor,  # [B, T*hop]
    mel_target: torch.Tensor,  # [B, T, n_mels] log-mel
    frame_mask: torch.Tensor,  # [B, T]
    cfg,
) -> torch.Tensor:
    """L1 between log-mel(vocoded audio) and the target log-mel (HiFi-GAN's λ_mel
    term): the metric the checkpoint eval grades."""
    mel_pred = mel_spectrogram(
        wav_pred, sr=cfg.sample_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length, n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax,
    )
    t = min(mel_pred.shape[-2], mel_target.shape[-2])
    return masked_l1(mel_pred[..., :t, :], mel_target[..., :t, :], frame_mask[..., :t])


def lsgan_discriminator_loss(real_outs: List, fake_outs: List) -> torch.Tensor:
    """HiFi-GAN eq(1): (D(x)-1)^2 + D(G(s))^2, summed over sub-discriminators."""
    loss = 0.0
    for (real_logits, _), (fake_logits, _) in zip(real_outs, fake_outs):
        loss = loss + global_mean((real_logits - 1.0) ** 2) + global_mean(fake_logits**2)
    return loss


def lsgan_generator_loss(fake_outs: List) -> torch.Tensor:
    """HiFi-GAN eq(2): (D(G(s))-1)^2."""
    loss = 0.0
    for fake_logits, _ in fake_outs:
        loss = loss + global_mean((fake_logits - 1.0) ** 2)
    return loss


def feature_matching_loss(real_outs: List, fake_outs: List) -> torch.Tensor:
    """HiFi-GAN eq(3): L1 between real and fake intermediate discriminator
    features, SUMMED over (sub-discriminator x layer) terms, as the paper defines
    it (λ_fm = 2 in the generator objective is calibrated against that sum)."""
    loss = 0.0
    for (_, real_feats), (_, fake_feats) in zip(real_outs, fake_outs):
        for rf, ff in zip(real_feats, fake_feats):
            loss = loss + global_mean(torch.abs(rf - ff))
    return loss
