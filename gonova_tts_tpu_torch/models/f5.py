"""F5-TTS v1 (Chen et al. 2024, arXiv:2410.06885) in PyTorch: the DiT that predicts the
flow's velocity, its guided Euler sampler, and the transcribed prompt it clones from.

The model (`F5TTS_v1_Base`: dim 1024, depth 22, 16 heads of 64, ff_mult 2, text_dim
512, 4 ConvNeXt-V2 text blocks, text_mask_padding, no qk norm, rotary positions on
every head, no long skip) and the sampler are SWivid/F5-TTS's `DiT` and `CFM.sample`
at `utils_infer`'s defaults:

  * text: `Embedding(text_num_embeds + 1, text_dim)` of id + 1 (0 is the filler),
    plus the fixed table cat(cos, sin) of `precompute_freqs_cis(text_dim, 4096)`, then
    ConvNeXt-V2 blocks (depthwise k=7, LayerNorm eps 1e-6, Linear to 2 * text_dim,
    exact GELU, GRN over the row's frames, Linear back, residual), the filler zeroed
    after the embedding and after every block. Once a pass, for both guidance rows;
  * input: Linear over cat(x_t, prompt mel, text) to dim, plus ConvPositionEmbedding
    (two grouped convs k=31, 16 groups, each followed by Mish);
  * time: sinusoidal(256, scale 1000) → Linear → SiLU → Linear;
  * each block: adaLN-Zero (SiLU(t) → Linear to 6 * dim: shift, scale and gate of the
    attention and of the MLP), LayerNorm without affine (eps 1e-6), attention with
    rotary positions 0 … L-1 on q and k (θ 10000, interleaved pairs), the MLP Linear →
    tanh-GELU → Linear, each added through its gate;
  * output: AdaLayerNorm_Final (SiLU → Linear to 2 * dim: scale, shift), Linear to
    n_mels;
  * sampler: Euler over t = linspace(0, 1, nfe + 1) sway-sampled (t + s * (cos(π/2 t)
    - 1 + t)), the velocity v_c + cfg * (v_c - v_u) of the conditional row and the
    null row (prompt mel zeroed, every text id the filler) run as one 2B-row batch;
    the prompt's frames replaced by the prompt at the end.

A batch pads its rows of L_i frames to one frame bucket, and a row computes what it
computes alone at L_i: attention masks every row's padded keys (F5's
`attn_mask_enabled`, off in the published v1 config, where padded frames of a batch
leak into each other), the position convs see zeros past L_i before each conv (the
published module masks before the first and after the second only), and GRN's norm
runs over the row's own frames (the published batched path runs the text embedding
row by row for that). Each row's x_0 is its own: drawn on the host in float32 at
[L_i, n_mels] from a generator seeded by a stable hash of the row's L_i and character
ids (`noise`), where F5 seeds the global generator once a call.

Products run in the engine's compute dtype with the weights cast once (`prepared`),
the rotary turn and the adaLN modulations too; LayerNorm statistics, softmax, the
time grid and the Euler state are float32.

Parameters (`[in, out]` dense weights, `[k, C_in / groups, C_out]` conv weights, the
port's layout): `text_embed/table`, `text_blocks/i/{dw, ln, pw1, grn, pw2}`,
`input_proj`, `conv_pos/{0,1}`, `time_mlp/{0,1}`, `blocks/i/{ada, attn/{q,k,v,o}, ff1,
ff2}`, `norm_out`, `proj_out`. F5's `initialize_weights` zeroes every adaLN Linear and
`proj_out`, which makes an untrained model the identity; `init` draws them all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.resample import resample
from ..config import ModelConfig
from ..text.chars import char_ids, read_text, with_stop
from . import graphs, layers
from .layers import Tree

MAX_POS = 4096  # the text positions' table, and the longest row F5 samples
TIME_DIM = 256
TEXT_NUM_EMBEDS = 2545  # the published vocab.txt's symbols; id 0 of the table is the filler
CFG_STRENGTH = 2.0  # utils_infer's guidance
SWAY_COEF = -1.0  # utils_infer's sway sampling
TARGET_RMS = 0.1  # a quieter prompt is raised to it, the output scaled back


# ---------------------------------------------------------------- parameters


def _convnext_v2(g: torch.Generator, dim: int, ff: int) -> Tree:
    node = layers.group(
        dw=layers.leaf(w=torch.randn((7, dim), generator=g) / math.sqrt(7.0), b=torch.zeros(dim)),
        ln=layers.layernorm_init(dim),
        pw1=layers.dense_init(g, dim, ff),
        grn=layers.leaf(gamma=torch.zeros(ff), beta=torch.zeros(ff)),
        pw2=layers.dense_init(g, ff, dim),
    )
    return node


def _block(g: torch.Generator, dim: int, ff: int) -> Tree:
    return layers.group(
        ada=layers.dense_init(g, dim, 6 * dim), attn=layers.mha_init(g, dim),
        ff1=layers.dense_init(g, dim, ff), ff2=layers.dense_init(g, ff, dim),
    )


class DiT(Tree):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d, td, m = cfg.f5_dim, cfg.f5_text_dim, cfg.n_mels
        self.text_embed = layers.embedding_init(g, TEXT_NUM_EMBEDS + 1, td)
        self.text_blocks = nn.ModuleList(_convnext_v2(g, td, 2 * td) for _ in range(cfg.f5_conv_layers))
        self.input_proj = layers.dense_init(g, 2 * m + td, d)
        self.conv_pos = nn.ModuleList(layers.conv1d_init(g, d, d, 31, groups=16) for _ in range(2))
        self.time_mlp = nn.ModuleList([layers.dense_init(g, TIME_DIM, d), layers.dense_init(g, d, d)])
        self.blocks = nn.ModuleList(_block(g, d, cfg.f5_ff_mult * d) for _ in range(cfg.f5_depth))
        self.norm_out = layers.dense_init(g, d, 2 * d)
        self.proj_out = layers.dense_init(g, d, m)


def init(g: torch.Generator, cfg: ModelConfig) -> DiT:
    return DiT(cfg, g)


def prepared(p: Mapping, dtype) -> dict:
    """The weights as the pass reads them, built once per dtype: cast to `dtype`,
    dense weights as [out, in] (F.linear's), conv weights as [C_out, C_in / groups,
    k], q, k and v as one product."""

    def build():
        def c(t):
            return t.detach().to(dtype)

        def lin(q):
            return (c(q["w"]).t(), c(q["b"]))

        def conv(q):
            return (c(q["w"]).permute(2, 1, 0).contiguous(), c(q["b"]))

        text = [{
            "dw": (c(b["dw"]["w"]).t().contiguous()[:, None, :], c(b["dw"]["b"])),
            "ln": (c(b["ln"]["g"]), c(b["ln"]["b"])), "pw1": lin(b["pw1"]), "pw2": lin(b["pw2"]),
            "grn": (c(b["grn"]["gamma"]), c(b["grn"]["beta"])),
        } for b in p["text_blocks"]]
        blocks = [{
            "ada": lin(b["ada"]),
            "qkv": (torch.cat([c(b["attn"][n]["w"]) for n in "qkv"], dim=1).t().contiguous(),
                    torch.cat([c(b["attn"][n]["b"]) for n in "qkv"])),
            "o": lin(b["attn"]["o"]), "ff1": lin(b["ff1"]), "ff2": lin(b["ff2"]),
        } for b in p["blocks"]]
        return {
            "table": c(p["text_embed"]["table"]), "text": text, "input": lin(p["input_proj"]),
            "conv_pos": [conv(q) for q in p["conv_pos"]], "time": [lin(q) for q in p["time_mlp"]],
            "blocks": blocks, "norm_out": lin(p["norm_out"]), "proj_out": lin(p["proj_out"]),
        }

    return layers.cached(p, ("f5.prepared", dtype), build)


# ---------------------------------------------------------------- constants


def _text_positions(dim: int) -> np.ndarray:
    """`precompute_freqs_cis(dim, MAX_POS)`: cat(cos, sin) of position * θ^(-2i/dim)."""
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float32) / dim))
    ang = np.outer(np.arange(MAX_POS, dtype=np.float32), freqs).astype(np.float32)
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=-1)


def _rope(dh: int) -> np.ndarray:
    """cos and signed sin [2, MAX_POS, dh] of x_transformers' `RotaryEmbedding(dh)`
    (64 in F5): pair i of (2i, 2i + 1) turns by position * 10000^(-2i/dh), so that
    x turned is x * cos + (x with each pair swapped) * sin, -sin on the pair's first."""
    inv = 1.0 / (10000.0 ** (np.arange(0, dh, 2).astype(np.float32) / dh))
    ang = np.repeat(np.outer(np.arange(MAX_POS, dtype=np.float32), inv).astype(np.float32), 2, axis=-1)
    sign = np.tile(np.array([-1.0, 1.0], np.float32), dh // 2)
    return np.stack([np.cos(ang), np.sin(ang) * sign])


def time_grid(cfg: ModelConfig) -> np.ndarray:
    """The `f5_nfe_steps` + 1 sway-sampled times of the Euler grid (float32)."""
    t = torch.linspace(0.0, 1.0, cfg.f5_nfe_steps + 1, dtype=torch.float32)
    return (t + SWAY_COEF * (torch.cos(torch.pi / 2 * t) - 1.0 + t)).numpy()


def _constants(cfg: ModelConfig, device) -> dict:
    half, dh = TIME_DIM // 2, cfg.f5_dim // cfg.f5_heads
    return {
        "text_pos": layers.device_constant(("f5.text_pos", cfg.f5_text_dim), lambda: _text_positions(cfg.f5_text_dim), device),
        "rope": layers.device_constant(("f5.rope", dh), lambda: _rope(dh), device),
        "time_freqs": layers.device_constant(
            ("f5.time_freqs",), lambda: np.exp(np.arange(half, dtype=np.float32) * -(math.log(10000.0) / (half - 1))).astype(np.float32),
            device),
        "grid": layers.device_constant(("f5.grid", cfg.f5_nfe_steps), lambda: time_grid(cfg), device),
    }


# ---------------------------------------------------------------- the pass


def _frames(lens: torch.Tensor, length: int) -> torch.Tensor:
    """[B, length] bool: frame < the row's L."""
    return torch.arange(length, device=lens.device)[None, :] < lens[:, None]


def _convnext_v2_apply(w: dict, x: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """One text block over x [B, L, C]; `frames` [B, L, 1] marks the row's frames,
    over which GRN takes its norm."""
    dw_w, dw_b = w["dw"]
    h = F.conv1d(x.transpose(1, 2), dw_w, dw_b, padding=3, groups=x.shape[-1]).transpose(1, 2)
    h = F.layer_norm(h, (h.shape[-1],), *w["ln"], eps=1e-6)
    h = F.gelu(F.linear(h, *w["pw1"]))
    gx = torch.linalg.vector_norm(h * frames, dim=1, keepdim=True)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    gamma, beta = w["grn"]
    h = gamma * (h * nx) + beta + h
    return x + F.linear(h, *w["pw2"])


def condition(params: Mapping, ids1: torch.Tensor, cond: torch.Tensor, lens: torch.Tensor, cfg: ModelConfig,
              dtype) -> torch.Tensor:
    """What every step of a pass reads besides x_t: cat(prompt mel, text embedding)
    [2B, L, n_mels + text_dim], the conditional rows, then the null rows (prompt
    zeroed, every id the filler; the filler mask stays the conditional row's, as in
    F5's `drop_text`). `ids1` [B, L]: character id + 1, 0 past the text."""
    w, k = prepared(params, dtype), _constants(cfg, cond.device)
    b, length = ids1.shape
    keep = (ids1 != 0).repeat(2, 1)[..., None]
    frames = _frames(lens, length).repeat(2, 1)[..., None]
    ids = torch.cat([ids1, torch.zeros_like(ids1)])
    x = (F.embedding(ids, w["table"]) + k["text_pos"][:length].to(dtype)) * keep
    for blk in w["text"]:
        x = _convnext_v2_apply(blk, x, frames) * keep
    c = cond.to(dtype)
    return torch.cat([torch.cat([c, torch.zeros_like(c)]), x], dim=-1)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., L, 2, H, dh] (q and k of every head) turned pair by pair with `_rope`'s
    tables [L, 1, 1, dh]: x * cos + (x, each pair swapped) * signed sin."""
    swapped = x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return torch.addcmul(x * cos, swapped, sin)


def velocity(params: Mapping, x: torch.Tensor, fixed: torch.Tensor, lens: torch.Tensor, t: torch.Tensor,
             cfg: ModelConfig, dtype) -> torch.Tensor:
    """The DiT over both guidance rows: x [B, L, n_mels] (f32), `fixed` from
    `condition`, t [1] → the guided velocity [B, L, n_mels] (f32)."""
    w, k = prepared(params, dtype), _constants(cfg, x.device)
    b, length, _ = x.shape
    d, heads = cfg.f5_dim, cfg.f5_heads
    keys = _frames(lens, length).repeat(2, 1)  # [2B, L]
    frames = keys[..., None].to(dtype)

    e = 1000.0 * t[:, None] * k["time_freqs"][None, :]
    temb = torch.cat([torch.sin(e), torch.cos(e)], dim=-1).to(dtype)
    temb = F.linear(F.silu(F.linear(temb, *w["time"][0])), *w["time"][1])
    temb = F.silu(temb)  # every adaLN reads SiLU(t)

    h = F.linear(torch.cat([x.to(dtype).repeat(2, 1, 1), fixed], dim=-1), *w["input"])
    c = h
    for conv_w, conv_b in w["conv_pos"]:
        c = F.mish(F.conv1d((c * frames).transpose(1, 2), conv_w, conv_b, padding=15, groups=16).transpose(1, 2))
    h = h + c * frames

    cos, sin = k["rope"][:, :length, None, None, :].to(dtype)
    mask = keys[:, None, None, :]
    for blk in w["blocks"]:
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = F.linear(temb, *blk["ada"]).chunk(6, dim=-1)
        n = torch.addcmul(shift_msa, F.layer_norm(h, (d,), eps=1e-6), 1 + scale_msa)
        qkv = F.linear(n, *blk["qkv"]).view(2 * b, length, 3, heads, d // heads)
        qk = _rotate(qkv[:, :, :2], cos, sin)
        o = F.scaled_dot_product_attention(qk[:, :, 0].transpose(1, 2), qk[:, :, 1].transpose(1, 2),
                                           qkv[:, :, 2].transpose(1, 2), attn_mask=mask)
        h = torch.addcmul(h, gate_msa, F.linear(o.transpose(1, 2).reshape(2 * b, length, d), *blk["o"]))
        n = torch.addcmul(shift_mlp, F.layer_norm(h, (d,), eps=1e-6), 1 + scale_mlp)
        h = torch.addcmul(h, gate_mlp, F.linear(F.gelu(F.linear(n, *blk["ff1"]), approximate="tanh"), *blk["ff2"]))

    scale, shift = F.linear(temb, *w["norm_out"]).chunk(2, dim=-1)
    v = F.linear(torch.addcmul(shift, F.layer_norm(h, (d,), eps=1e-6), 1 + scale), *w["proj_out"]).float()
    v_c, v_u = v.chunk(2)
    return v_c + (v_c - v_u) * CFG_STRENGTH


def step(params, x, fixed, lens, times, cfg: ModelConfig, dtype) -> torch.Tensor:
    """One Euler step from times[0] to times[1]."""
    return x + (times[1] - times[0]) * velocity(params, x, fixed, lens, times[:1], cfg, dtype)


def finish(x: torch.Tensor, cond: torch.Tensor, prompt_frames: torch.Tensor, ref_len: torch.Tensor,
           lens: torch.Tensor) -> torch.Tensor:
    """The sampled x_1 with the prompt's frames put back, shifted so that row i's
    frames ref_len_i … L_i - 1 (what F5 hands its vocoder) come first, zeros after."""
    b, length, m = x.shape
    pos = torch.arange(length, device=x.device)
    out = torch.where((pos[None, :] < prompt_frames[:, None])[..., None], cond, x)
    idx = ref_len[:, None] + pos[None, :]
    valid = (idx < lens[:, None])[..., None]
    return torch.gather(out, 1, idx.clamp(max=length - 1)[..., None].expand(b, length, m)) * valid


def sample(params: Mapping, ids1: torch.Tensor, cond: torch.Tensor, noise: torch.Tensor, lens: torch.Tensor,
           prompt_frames: torch.Tensor, ref_len: torch.Tensor, cfg: ModelConfig, dtype=torch.float32,
           on_step: Optional[Callable[[], None]] = None) -> torch.Tensor:
    """A batch's generated mel [B, L, n_mels] (f32; see `finish`). Inputs, each
    padded to the frame bucket L: `ids1` [B, L] (character id + 1, 0 after the
    text), `cond` [B, L, n_mels] (the prompt's log-mel, zeros after), `noise`
    [B, L, n_mels] (x_0, zeros after L_i), and per row `lens` (L_i), `prompt_frames`
    and `ref_len` [B]. Where the serving pass has graphs, the conditioning, each
    Euler step and the last gather each replay one (`graphs.run`): a pass replays
    one step's graph `f5_nfe_steps` times, the times copied into it. `on_step` is
    called as each step is launched, replayed or eager."""
    grid = _constants(cfg, noise.device)["grid"]
    key = (id(cfg), dtype)
    fixed = graphs.run("f5.condition", lambda: condition(params, ids1, cond, lens, cfg, dtype), params,
                       (ids1, cond, lens), *key)
    x = noise
    for k in range(cfg.f5_nfe_steps):
        times = grid[k : k + 2].clone()  # a tensor of its own: a replay copies it into the graph's

        def one(x=x, times=times):
            return step(params, x, fixed, lens, times, cfg, dtype)

        x = graphs.run("f5.step", one, params, (x, fixed, lens, times), *key)
        if on_step is not None:
            on_step()
    return graphs.run("f5.finish", lambda: finish(x, cond, prompt_frames, ref_len, lens), params,
                      (x, cond, prompt_frames, ref_len, lens), *key)


# ---------------------------------------------------------------- prompts and rows


@dataclass
class Prompt:
    """A voice as F5 clones it: the reference's log-mel [frames, n_mels] (f32), its
    transcript as the model reads it (ending in ". "), `ref_len` (samples // hop:
    where the generated frames start) and the gain the output is scaled by."""

    mel: np.ndarray
    text: str
    ref_len: int
    gain: float = 1.0

    @property
    def frames(self) -> int:
        return self.mel.shape[0]


def _htk_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """torchaudio's `melscale_fbanks` (HTK scale, no norm, 0 to sr / 2): [bins, n_mels]."""
    freqs = np.linspace(0.0, sr // 2, n_fft // 2 + 1)
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    pts = 700.0 * (10.0 ** (np.linspace(mel(0.0), mel(sr / 2), n_mels + 2) / 2595.0) - 1.0)
    diff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    down, up = -slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel(wav: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Vocos's log-mel of [T] audio at the model rate: |STFT| (centred, reflect pad,
    periodic Hann) through the HTK filterbank, log(clamp(·, 1e-5)): [T // hop + 1,
    n_mels] f32."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    window = torch.hann_window(cfg.win_length, device=wav.device)
    spec = torch.stft(wav.float(), n_fft, hop, cfg.win_length, window, center=True, pad_mode="reflect",
                      return_complex=True).abs()
    fb = layers.device_constant(("f5.htk", cfg.sample_rate, n_fft, cfg.n_mels),
                                lambda: _htk_filterbank(cfg.sample_rate, n_fft, cfg.n_mels), wav.device)
    return torch.log(torch.clamp(spec.t() @ fb, min=1e-5))


def make_prompt(audio: np.ndarray, sr: int, transcript: str, cfg: ModelConfig, device) -> Prompt:
    """A reference recording and its transcript → the Prompt: mono, raised to
    `TARGET_RMS` if quieter (the output is scaled back), resampled to the model
    rate, its log-mel."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    rms = float(np.sqrt(np.mean(np.square(audio, dtype=np.float64))))
    gain = 1.0
    if 0.0 < rms < TARGET_RMS:
        audio, gain = audio * (TARGET_RMS / rms), rms / TARGET_RMS
    wav = resample(torch.as_tensor(audio, device=device), sr, cfg.sample_rate)
    mel = log_mel(wav, cfg).cpu().numpy()
    return Prompt(mel, with_stop(read_text(transcript)), wav.shape[-1] // cfg.hop_length, gain)


@dataclass
class Row:
    """One sentence against one prompt: the character ids of transcript and
    sentence, and the row's frame count L."""

    ids: list
    frames: int
    prompt: Prompt


def plan(sentence: str, prompt: Prompt, cfg: ModelConfig) -> Row:
    """F5's duration rule in bytes of UTF-8 at its default speed 1: L = ref_len +
    int(ref_len / bytes(ref text) * bytes(sentence)), at least one frame past the text
    and the prompt, at most MAX_POS."""
    text = read_text(sentence)
    ids = char_ids(prompt.text + text)
    ref_bytes, gen_bytes = len(prompt.text.encode("utf-8")), len(text.encode("utf-8"))
    frames = prompt.ref_len + int(prompt.ref_len / ref_bytes * gen_bytes)
    frames = min(max(max(len(ids), prompt.frames) + 1, frames), MAX_POS)
    return Row(ids, frames, prompt)


def noise(ids, frames: int, n_mels: int) -> np.ndarray:
    """A row's x_0 [frames, n_mels] (f32): standard normal from a CPU generator
    seeded by numpy's SeedSequence (a stable hash) of the row's frames and ids."""
    seed = int(np.random.SeedSequence([int(frames), *map(int, ids)]).generate_state(1, np.uint64)[0]) >> 1
    g = torch.Generator().manual_seed(seed)
    return torch.randn((frames, n_mels), generator=g, dtype=torch.float32).numpy()
