"""The plain float32 reference of the f5 family: F5-TTS v1 Base (Chen et al. 2024,
arXiv:2410.06885; SWivid/F5-TTS `F5TTS_v1_Base` with `utils_infer`'s defaults) and
Vocos at 100 bands, from a prompt (a recording and its transcript) and a sentence to
PCM16.

Written from the published code's description, one sentence at a time at its exact
frame count L, with no padding, no cache, no graph and no batching beyond the two
guidance rows that `CFM.sample` packs:

  * text: the sentence normalized (text/normalize.py); the transcript normalized and
    ended in ". " (F5's rule: a final "." gains a space, anything else ". "); one id
    per character of transcript + sentence (printable ASCII in code-point order, the
    space 0, anything else 0);
  * duration: L = ref_len + int(ref_len / bytes(transcript) * bytes(sentence) /
    speed) at speed 1, ref_len = the prompt's samples // hop, at least one frame past
    the text and the prompt's frames, at most 4096;
  * prompt: mono, raised to `TARGET_RMS` if quieter (the output scaled back by
    the same factor), resampled to 24 kHz (audio.py), Vocos's log-mel: |STFT| of the
    reflect-padded, centred frames under a periodic Hann, an HTK filterbank without
    norm (0 to 12 kHz), log(clamp(·, 1e-5)): ref_len + 1 frames;
  * the DiT: the text embedding (embedding of id + 1, the cat(cos, sin) positions,
    ConvNeXt-V2 blocks with GRN, filler zeroed after each), the input projection of
    cat(x_t, prompt mel, text), the grouped position convs with Mish, the time MLP,
    22 adaLN-Zero blocks with rotary attention (interleaved pairs, θ 10000) and a
    tanh-GELU MLP, AdaLayerNorm_Final and the projection; the null row zeroes the
    prompt and replaces every id by the filler, keeping the conditional row's filler
    mask (F5's `drop_text`);
  * the sampler: Euler over the sway-sampled grid linspace(0, 1, nfe + 1), the
    velocity v_c + cfg * (v_c - v_u); the prompt's frames put back at the end, the
    frames from ref_len to L to the vocoder;
  * Vocos: model.py's NovaVocos (its polar head), which sees the generated frames
    followed by zero frames, as the served dispatch does past every row;
  * audio: scaled back by the prompt's gain, then PCM16 as the engine hands it on.

Departures from the published code, each one the served program shares: the
padded keys of a batch are masked in attention (F5 exposes `attn_mask_enabled`,
off in the v1 config), which a row alone never needs; x_0 is drawn per sentence on
the CPU in float32 from a generator seeded by numpy's SeedSequence of L and its
ids (F5 seeds the global generator once); the reference recording
is used as given (no silence trimming, no 50 ms tail); Vocos is the repository's
NovaVocos (tanh GELU, log-magnitude clamped to [-14, 6], the constant-envelope
"same" iSTFT), which the weights drawn from the seed are made for.

`Numerics` rounds the operands of every product (dense, conv, attention and the
inverse DFT) for the float8 control. It imports nothing of the served program.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import audio, model
from .model import FP32, Numerics
from .text.normalize import normalize_text

MAX_POS = 4096
CFG_STRENGTH = 2.0  # utils_infer's cfg_strength
SWAY_COEF = -1.0  # utils_infer's sway_sampling_coef
TARGET_RMS = 0.1  # utils_infer's target_rms


def char_ids(text: str):
    return [ord(c) - 32 if 32 <= ord(c) < 127 else 0 for c in text]


def with_stop(ref_text: str) -> str:
    if ref_text.endswith(". ") or ref_text.endswith("。"):
        return ref_text
    return ref_text + (" " if ref_text.endswith(".") else ". ")


def frames_of(ref_len: int, prompt_frames: int, ref_text: str, text: str, n_ids: int, speed: float = 1.0) -> int:
    ref_bytes, gen_bytes = len(ref_text.encode("utf-8")), len(text.encode("utf-8"))
    duration = ref_len + int(ref_len / ref_bytes * gen_bytes / speed)
    return min(max(max(n_ids, prompt_frames) + 1, duration), MAX_POS)


def noise(ids, frames: int, n_mels: int) -> torch.Tensor:
    seed = int(np.random.SeedSequence([int(frames), *map(int, ids)]).generate_state(1, np.uint64)[0]) >> 1
    g = torch.Generator().manual_seed(seed)
    return torch.randn((frames, n_mels), generator=g, dtype=torch.float32)


def htk_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangles between HTK-mel-spaced points from 0 to sr / 2, peak 1: [bins, n_mels]."""
    freqs = np.linspace(0.0, sr // 2, n_fft // 2 + 1)
    pts = 700.0 * (10.0 ** (np.linspace(0.0, 2595.0 * np.log10(1.0 + (sr / 2) / 700.0), n_mels + 2) / 2595.0) - 1.0)
    lo, mid, hi = pts[None, :-2], pts[None, 1:-1], pts[None, 2:]
    f = freqs[:, None]
    return np.maximum(0.0, np.minimum((f - lo) / (mid - lo), (hi - f) / (hi - mid)))


def vocos_log_mel(x: torch.Tensor, s: dict) -> torch.Tensor:
    """[T] → [T // hop + 1, n_mels]."""
    n_fft, hop = s["n_fft"], s["hop_length"]
    xp = F.pad(x.reshape(1, 1, -1).float(), (n_fft // 2, n_fft // 2), mode="reflect").reshape(-1)
    frames = xp.unfold(0, n_fft, hop) * audio.hann(n_fft, x.device)
    mag = torch.fft.rfft(frames, dim=-1).abs()
    fb = torch.as_tensor(htk_filterbank(s["sample_rate"], n_fft, s["n_mels"]), dtype=torch.float32, device=x.device)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))


def dense(p, x, num: Numerics):
    return num.q(x) @ num.q(p["w"]) + p["b"]


def layernorm(x, eps: float = 1e-6, p=None):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y if p is None else y * p["g"] + p["b"]


def conv(p, x, num: Numerics, groups: int = 1):
    """Zero-padded ("same", odd k) conv over x [B, T, C_in], w [k, C_in / groups, C_out]."""
    w = p["w"]
    k = w.shape[0]
    y = F.conv1d(num.q(x).transpose(1, 2), num.q(w).permute(2, 1, 0), padding=k // 2, groups=groups)
    return y.transpose(1, 2) + p["b"]


class DiT:
    """F5's DiT over the two guidance rows of one sentence, in float32."""

    def __init__(self, tree: Dict, s: Dict, num: Numerics):
        self.p, self.s, self.num = tree, s, num

    def text(self, ids: torch.Tensor, length: int) -> torch.Tensor:
        """ids [n] → [2, L, text_dim] (conditional row, null row)."""
        p, num, td = self.p, self.num, self.s["f5_text_dim"]
        dev = ids.device
        text = F.pad(ids[:length] + 1, (0, length - min(len(ids), length)))
        keep = (text != 0).float()[None, :, None]
        rows = torch.stack([text, torch.zeros_like(text)])
        freqs = 1.0 / (10000.0 ** (torch.arange(0, td, 2, device=dev)[: td // 2].float() / td))
        ang = torch.outer(torch.arange(MAX_POS, device=dev).float(), freqs)
        pos = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)[:length]
        x = (p["text_embed"]["table"][rows] + pos) * keep
        for blk in p["text_blocks"]:
            c = x.shape[-1]
            h = F.conv1d(x.transpose(1, 2), blk["dw"]["w"].t()[:, None, :], padding=3, groups=c).transpose(1, 2) + blk["dw"]["b"]
            h = F.gelu(dense(blk["pw1"], layernorm(h, p=blk["ln"]), num))
            gx = torch.sqrt((h * h).sum(dim=1, keepdim=True))
            nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
            h = blk["grn"]["gamma"] * (h * nx) + blk["grn"]["beta"] + h
            x = (x + dense(blk["pw2"], h, num)) * keep
        return x

    def velocity(self, x: torch.Tensor, cond: torch.Tensor, text: torch.Tensor, t: float) -> torch.Tensor:
        """x [L, n_mels], cond [L, n_mels] (zeros after the prompt), text [2, L, td] → v [L, n_mels]."""
        p, s, num = self.p, self.s, self.num
        length, d, heads = x.shape[0], s["f5_dim"], s["f5_heads"]
        dh = d // heads
        dev = x.device
        half = 128
        freqs = torch.exp(torch.arange(half, device=dev).float() * -(math.log(10000.0) / (half - 1)))
        e = 1000.0 * t * freqs[None]
        temb = torch.cat([torch.sin(e), torch.cos(e)], dim=-1)
        temb = dense(p["time_mlp"][1], F.silu(dense(p["time_mlp"][0], temb, num)), num)  # [1, d]

        rows = torch.cat([torch.stack([x, x]), torch.stack([cond, torch.zeros_like(cond)]), text], dim=-1)
        h = dense(p["input_proj"], rows, num)
        c = h
        for q in p["conv_pos"]:
            c = F.mish(conv(q, c, num, groups=16))
        h = h + c

        inv = 1.0 / (10000.0 ** (torch.arange(0, dh, 2, device=dev).float() / dh))
        ang = torch.outer(torch.arange(length, device=dev).float(), inv).repeat_interleave(2, dim=-1)
        cos, sin = torch.cos(ang), torch.sin(ang)

        def rotate(z):
            z1, z2 = z[..., 0::2], z[..., 1::2]
            turned = torch.stack((-z2, z1), dim=-1).flatten(-2)
            return z * cos + turned * sin

        for blk in p["blocks"]:
            mod = dense(blk["ada"], F.silu(temb), num)
            shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
            n = layernorm(h) * (1 + scale_msa) + shift_msa
            q, k, v = (dense(blk["attn"][name], n, num).reshape(2, length, heads, dh).transpose(1, 2) for name in "qkv")
            q, k = rotate(q), rotate(k)
            attn = torch.softmax((num.q(q) @ num.q(k).transpose(-1, -2)) / math.sqrt(dh), dim=-1)
            o = (num.q(attn) @ num.q(v)).transpose(1, 2).reshape(2, length, d)
            h = h + gate_msa * dense(blk["attn"]["o"], o, num)
            n = layernorm(h) * (1 + scale_mlp) + shift_mlp
            h = h + gate_mlp * dense(blk["ff2"], F.gelu(dense(blk["ff1"], n, num), approximate="tanh"), num)
        scale, shift = dense(p["norm_out"], F.silu(temb), num).chunk(2, dim=-1)
        out = dense(p["proj_out"], layernorm(h) * (1 + scale) + shift, num)
        v_c, v_u = out[0], out[1]
        return v_c + (v_c - v_u) * CFG_STRENGTH


class Reference:
    """The f5 family's function, from its checkpoint tree and its settings."""

    def __init__(self, tree: Dict, settings: Dict, device, num: Numerics = FP32):
        self.s, self.device, self.num = settings, device, num
        self.dit = DiT(tree["acoustic"], settings, num)
        self.vocoder = model.Reference(tree, settings, device, num)

    def prompt(self, wav: np.ndarray, sr: int, transcript: str) -> dict:
        """A recording (mono or [T, channels]) and its transcript → the prompt."""
        s = self.s
        x = np.asarray(wav, np.float64)
        if x.ndim > 1:
            x = x.mean(axis=1)
        rms = float(np.sqrt(np.mean(x.astype(np.float32).astype(np.float64) ** 2)))
        gain = 1.0
        if 0.0 < rms < TARGET_RMS:
            x, gain = x * (TARGET_RMS / rms), rms / TARGET_RMS
        y = torch.as_tensor(audio.resample(x, sr, s["sample_rate"]), dtype=torch.float32, device=self.device)
        return {"mel": vocos_log_mel(y, s), "text": with_stop(normalize_text(transcript)),
                "ref_len": y.shape[0] // s["hop_length"], "gain": gain}

    def times(self) -> torch.Tensor:
        s = self.s
        t = torch.linspace(0.0, 1.0, s["f5_nfe_steps"] + 1, dtype=torch.float32, device=self.device)
        return t + SWAY_COEF * (torch.cos(torch.pi / 2 * t) - 1.0 + t)

    def mel(self, sentence: str, prompt: dict) -> torch.Tensor:
        """The generated log-mel [L - ref_len, n_mels] of one sentence."""
        s, dev = self.s, self.device
        text = normalize_text(sentence)
        ids = char_ids(prompt["text"] + text)
        pm = prompt["mel"]
        length = frames_of(prompt["ref_len"], pm.shape[0], prompt["text"], text, len(ids))
        cond = torch.zeros((length, s["n_mels"]), device=dev)
        cond[: pm.shape[0]] = pm[:length]
        text_emb = self.dit.text(torch.as_tensor(ids, device=dev), length)
        x = noise(ids, length, s["n_mels"]).to(dev)
        t = self.times()
        for k in range(s["f5_nfe_steps"]):
            x = x + (t[k + 1] - t[k]) * self.dit.velocity(x, cond, text_emb, t[k : k + 1])
        x[: pm.shape[0]] = cond[: pm.shape[0]]
        return x[prompt["ref_len"] :]

    def speak(self, sentence: str, prompt: dict) -> np.ndarray:
        """One sentence's audio as the service returns it (float32 of PCM16 steps)."""
        with torch.no_grad():
            wav = self.vocoder.vocode(self.mel(sentence, prompt)) * prompt["gain"]
        return model.pcm16_served(wav.cpu().numpy())
