"""The plain reference of the served model: text → ids → acoustic model → vocoder →
PCM16, and a reference recording → speaker embedding, in float32 PyTorch.

Written from the model's description, one sentence at a time, with no kernel, no
cache, no bucketing and no batching:

  * acoustic model (FastPitch-class): token embedding + sinusoidal positions +
    projected speaker embedding → pre-LN transformer encoder (conv FFN, k=3) →
    duration and pitch predictors (conv-LN-conv-LN-dense each) → durations
    clamp(round_half_even(exp(log_dur) - 1), 1, max_frames_per_token) → pitch
    conditioning (mean + (1 + exaggeration) * deviation, a dense from 1 to d_model)
    → length regulation → decoder (the same block; blocked local attention of
    `decoder_attention_window` frames when the sentence's token bucket times
    `max_frames_per_token` reaches `local_attention_min_frames`, full attention
    otherwise) → dense to n_mels;
  * NovaVocos (Vocos, arXiv:2306.00814, with the served checkpoint's cartesian or
    polar head): k=7 embed conv → ConvNeXt blocks → LN → STFT head → inverse real
    FFT, periodic Hann synthesis window, 4x overlap-add / 1.5, (n_fft - hop) / 2
    lead trim;
  * NovaGAN (HiFi-GAN V1 generator, arXiv:2010.05646): k=7 conv → per stage leaky
    ReLU, transposed conv (zero-stuffed input correlated with the kernel as stored),
    the mean of the multi-receptive-field residual stacks → k=7 conv → tanh;
  * speaker encoder: reference audio → 24 kHz (Kaiser-windowed sinc, polyphase)
    → the first 10 s, zero-padded → log-mel → three stride-2 convs (ReLU, LN) →
    masked mean and std → dense → L2 normalization.

Every conv is SAME in the XLA sense (the smaller half of the padding on the left).
The vocoder sees the sentence's mel followed by zero frames, as the served two-stage
dispatch does past each sentence's last frame. Audio leaves as PCM16 the way the
engine hands it to the service: clamp(x * 32767) truncated to int16, / 32768 (the
REST result and the WebSocket's float32 pcm frames carry those values).

`Numerics` decides the precision of the operands of every product (matmuls and
convolutions): float32, or float8 e4m3 with a per-tensor scale for the control that
the comparison has to fail.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import audio

NEG = -1e9


class Numerics:
    """How the operands of a product are rounded: `fp32` leaves them, `fp8` rounds
    each to float8 e4m3 with the scale amax / 448 of its tensor."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return t
        scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


FP32 = Numerics("fp32")


# ---------------------------------------------------------------- weights


def load_tree(path: str, device) -> tuple:
    """(nested tree of float32 tensors on `device`, metadata) from a '/'-keyed npz;
    levels whose keys are all digits become lists."""
    root: dict = {}
    with np.load(path) as z:
        meta = json.loads(bytes(np.asarray(z["__meta__"])).decode()) if "__meta__" in z.files else {}
        for key in z.files:
            if key == "__meta__":
                continue
            node = root
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.as_tensor(np.asarray(z[key], np.float32), device=device)

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root), meta


# ---------------------------------------------------------------- layers


def dense(p, x, num: Numerics = FP32):
    return num.q(x) @ num.q(p["w"]) + p["b"]


def layernorm(p, x, eps: float = 1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["g"] + p["b"]


def conv1d(p, x, num: Numerics = FP32, stride: int = 1, dilation: int = 1, groups: int = 1):
    """SAME conv over x [B, T, C_in] with w [k, C_in / groups, C_out]."""
    w = p["w"]
    k = w.shape[0]
    span = (k - 1) * dilation + 1
    t = x.shape[1]
    t_out = -(-t // stride)
    total = max((t_out - 1) * stride + span - t, 0)
    xt = F.pad(num.q(x).transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(xt, num.q(w).permute(2, 1, 0), stride=stride, dilation=dilation, groups=groups)
    return y.transpose(1, 2) + p["b"]


def conv1d_transpose(p, x, stride: int, num: Numerics = FP32):
    """Transposed conv with output length T * stride: x zero-stuffed by `stride`,
    padded k - 1 - (k - stride) // 2 on each side, correlated with w as stored."""
    w = p["w"]
    k = w.shape[0]
    b, t, c = x.shape
    stuffed = torch.zeros((b, (t - 1) * stride + 1, c), device=x.device, dtype=x.dtype)
    stuffed[:, ::stride] = num.q(x)
    pad = k - 1 - (k - stride) // 2
    xt = F.pad(stuffed.transpose(1, 2), (pad, pad))
    y = F.conv1d(xt, num.q(w).permute(2, 1, 0))[:, :, : t * stride]
    return y.transpose(1, 2) + p["b"]


def sinusoidal_positions(length: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float64)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / dim)
    table = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(length, dim)
    return table.to(torch.float32).to(device)


def attention(p, x, n_heads: int, key_mask, num: Numerics, window: Optional[int]):
    """Self-attention over x [1, T, D]. `window`: each block of `window` queries sees
    its own block and both neighbours (T is a multiple of `window`)."""
    _, t, d = x.shape
    dh = d // n_heads
    q, k, v = (dense(p[n], x, num).reshape(t, n_heads, dh).transpose(0, 1) for n in ("q", "k", "v"))
    logits = (num.q(q) @ num.q(k).transpose(1, 2)) / math.sqrt(dh)  # [H, T, T]
    allowed = key_mask[None, :].bool().expand(t, t)
    if window is not None:
        blk = torch.arange(t, device=x.device) // window
        allowed = allowed & ((blk[:, None] - blk[None, :]).abs() <= 1)
    logits = logits + torch.where(allowed, 0.0, NEG)[None]  # a key bias, as served
    attn = torch.softmax(logits, dim=-1)
    out = (num.q(attn) @ num.q(v)).transpose(0, 1).reshape(1, t, d)
    return dense(p["o"], out, num)


def transformer_stack(p, x, mask, n_heads: int, num: Numerics, window: Optional[int] = None):
    m = mask[None, :, None]
    for blk in p["blocks"]:
        h = x + attention(blk["attn"], layernorm(blk["ln1"], x), n_heads, mask, num, window)
        h = h * m
        y = torch.relu(conv1d(blk["ff1"], layernorm(blk["ln2"], h), num))
        x = (h + conv1d(blk["ff2"], y, num)) * m
    return layernorm(p["ln_out"], x)


def predictor(p, x, mask, num: Numerics):
    """conv → ReLU → LN → conv → ReLU → LN → dense, over masked rows."""
    m = mask[None, :, None]
    h = layernorm(p["ln1"], torch.relu(conv1d(p["c1"], x * m, num))) * m
    h = layernorm(p["ln2"], torch.relu(conv1d(p["c2"], h, num)))
    return dense(p["out"], h, num)[..., 0] * mask


# ---------------------------------------------------------------- the model


class Reference:
    """The served model's function, from its checkpoint tree and its settings."""

    def __init__(self, tree: Dict, settings: Dict, device, num: Numerics = FP32):
        self.tree, self.s, self.device, self.num = tree, settings, device, num

    def mel(self, ids: List[int], bucket: int, speaker: np.ndarray, exaggeration: float) -> torch.Tensor:
        """Token ids (at most `bucket` of them) → log-mel [frames, n_mels]. The
        encoder runs over the token bucket and the decoder over at least two frames
        past the last, padded rows masked as the model defines them."""
        p, s, num, dev = self.tree["acoustic"], self.s, self.num, self.device
        n = len(ids)
        tokens = torch.zeros(bucket, dtype=torch.long, device=dev)
        tokens[:n] = torch.as_tensor(ids, device=dev)
        mask = (torch.arange(bucket, device=dev) < n).float()
        m = mask[None, :, None]
        spk = dense(p["spk_proj"], torch.as_tensor(speaker, device=dev)[None], num)  # [1, D]
        x = p["embed"]["table"][tokens][None] + sinusoidal_positions(bucket, s["d_model"], dev)[None]
        enc = transformer_stack(p["encoder"], (x + spk[:, None]) * m, mask, s["n_heads"], num)

        log_dur = predictor(p["dur_pred"], enc, mask, num)[0]
        pitch = predictor(p["pitch_pred"], enc, mask, num)[0]
        dur = torch.clamp(torch.round(torch.exp(log_dur[:n]) - 1.0), 1.0, float(s["max_frames_per_token"]))
        mean = pitch[:n].mean()
        pitch_scaled = (mean + (1.0 + exaggeration) * (pitch - mean)) * mask
        enc = (enc + dense(p["pitch_embed"], pitch_scaled[None, :, None], num)) * m

        frames = enc[0, :n].repeat_interleave(dur.to(torch.int64), dim=0)  # [T, D]
        total = frames.shape[0]
        window = s["decoder_attention_window"]
        if not (window and bucket * s["max_frames_per_token"] >= s["local_attention_min_frames"]):
            window = None
        t_pad = total + 2
        if window:
            t_pad = -(-t_pad // window) * window
        fmask = (torch.arange(t_pad, device=dev) < total).float()
        dec_in = (F.pad(frames, (0, 0, 0, t_pad - total))[None] + spk[:, None]) * fmask[None, :, None]
        dec = transformer_stack(p["decoder"], dec_in, fmask, s["n_heads"], num, window)
        return dense(p["mel_out"], dec, num)[0, :total]

    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        """log-mel [T, n_mels] → waveform [T * hop], with zero frames after the mel."""
        t = mel.shape[0]
        x = F.pad(mel, (0, 0, 0, 64))[None]
        if self.s["vocoder_family"] == "hifigan":
            wav = self._hifigan(x)
        else:
            wav = self._vocos(x)
        return wav[0, : t * self.s["hop_length"]]

    def _vocos(self, x):
        p, num, s = self.tree["vocoder"], self.num, self.s
        n_fft, hop = s["n_fft"], s["hop_length"]
        n_bins = n_fft // 2 + 1
        h = conv1d(p["embed"], x, num)
        for blk in p["blocks"]:
            k, c = blk["dw"].shape
            dw = F.conv1d(F.pad(h.transpose(1, 2), (k // 2, k // 2)), blk["dw"].t()[:, None, :], groups=c)
            y = layernorm(blk["ln"], dw.transpose(1, 2) + blk["dw_b"])
            y = dense(blk["pw2"], F.gelu(dense(blk["pw1"], y, num), approximate="tanh"), num)
            h = h + y * blk["gamma"]
        head = dense(p["head"], layernorm(p["ln_out"], h), num)
        mag = torch.exp(torch.clamp(head[..., :n_bins], -14.0, 6.0))
        if head.shape[-1] == 3 * n_bins:  # cartesian head: a magnitude and a direction
            xd, yd = head[..., n_bins : 2 * n_bins], head[..., 2 * n_bins :]
            inv = torch.rsqrt(xd * xd + yd * yd + 1e-12)
            real, imag = mag * xd * inv, mag * yd * inv
        else:  # polar head: a magnitude and a phase
            phase = head[..., n_bins:]
            real, imag = mag * torch.cos(phase), mag * torch.sin(phase)
        frames = torch.fft.irfft(torch.complex(num.q(real), num.q(imag)), n=n_fft, dim=-1)
        frames = frames * audio.hann(n_fft, frames.device)
        b, t, _ = frames.shape
        out = F.fold(
            frames.transpose(1, 2), output_size=(1, (t - 1) * hop + n_fft),
            kernel_size=(1, n_fft), stride=(1, hop),
        ).reshape(b, -1) / 1.5
        lead = (n_fft - hop) // 2
        return out[:, lead : lead + t * hop]

    def _hifigan(self, x):
        p, num, s = self.tree["vocoder"], self.num, self.s
        h = conv1d(p["conv_pre"], x, num)
        for up, mrf, rate in zip(p["ups"], p["mrfs"], s["upsample_rates"]):
            h = conv1d_transpose(up, F.leaky_relu(h, 0.1), rate, num)
            acc = 0.0
            for block, dilations in zip(mrf, s["resblock_dilations"]):
                y = h
                for c1, c2, d in zip(block["convs1"], block["convs2"], dilations):
                    r = conv1d(c1, F.leaky_relu(y, 0.1), num, dilation=d)
                    y = y + conv1d(c2, F.leaky_relu(r, 0.1), num)
                acc = acc + y
            h = acc / len(mrf)
        return torch.tanh(conv1d(p["conv_post"], F.leaky_relu(h, 0.1), num)[..., 0])

    def embed(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """Reference recording (mono or [T, channels]) → speaker embedding."""
        s, num = self.s, self.num
        wav = np.asarray(wav, np.float64)
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        y = audio.resample(wav, sr, s["sample_rate"])
        n_max = int(10.0 * s["sample_rate"])
        n_max -= n_max % s["hop_length"]
        n = min(len(y), n_max)
        buf = np.zeros(n_max, np.float32)
        buf[:n] = y[:n]
        mel = audio.log_mel(torch.as_tensor(buf, device=self.device), s)  # [T, n_mels]
        mask = (torch.arange(mel.shape[0], device=self.device) < n // s["hop_length"]).float()
        p = self.tree["speaker"]
        h = mel[None]
        for conv, ln in (("c1", "ln1"), ("c2", "ln2"), ("c3", "ln3")):
            h = layernorm(p[ln], torch.relu(conv1d(p[conv], h * mask[None, :, None], num, stride=2)))
            mask = mask[: h.shape[1] * 2 : 2]
        m = mask[None, :, None]
        denom = torch.clamp(m.sum(1), min=1.0)
        mean = (h * m).sum(1) / denom
        std = torch.sqrt(torch.clamp((((h - mean[:, None]) ** 2) * m).sum(1) / denom, min=1e-6))
        emb = dense(p["out"], torch.cat([mean, std], -1), num)[0]
        return (emb / torch.clamp(emb.norm(), min=1e-6)).cpu().numpy()

    def speak(self, ids: List[int], bucket: int, speaker: np.ndarray, exaggeration: float) -> np.ndarray:
        """One sentence's audio as the service returns it (float32 of PCM16 steps)."""
        with torch.no_grad():
            wav = self.vocode(self.mel(ids, bucket, speaker, exaggeration))
        return pcm16_served(wav.cpu().numpy())


def pcm16_served(wav: np.ndarray) -> np.ndarray:
    """The engine's transfer: int16(clamp(x * 32767, ±32767)), truncated, / 32768."""
    return np.clip(wav.astype(np.float32) * 32767.0, -32767.0, 32767.0).astype(np.int16).astype(np.float32) / 32768.0

