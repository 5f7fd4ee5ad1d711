"""NovaSpeech acoustic model (FastPitch-class, non-autoregressive), in PyTorch.

Counterpart of `gonova_tts_tpu/models/acoustic.py`:
phonemes [B, L] + speaker embedding [B, S] + exaggeration [B]
    → encoder (pre-LN transformer, conv FFN) → fused duration & pitch predictors
    → length regulator (T = L * max_frames_per_token) → decoder → log-mel [B, T, n_mels].
`encode` and `decode` are the two halves the engine's two-stage dispatch runs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops import transformer_stack as ts_op
from . import graphs, layers
from .layers import Tree


def predictor_init(g: torch.Generator, dim: int, hidden: int = 256, kernel: int = 3) -> Tree:
    return layers.group(
        c1=layers.conv1d_init(g, dim, hidden, kernel),
        ln1=layers.layernorm_init(hidden),
        c2=layers.conv1d_init(g, hidden, hidden, kernel),
        ln2=layers.layernorm_init(hidden),
        out=layers.dense_init(g, hidden, 1),
    )


def predictors_apply_fused(
    p_a: Mapping, p_b: Mapping, x: torch.Tensor, mask: torch.Tensor, dtype=torch.float32
):
    """Duration and pitch predictors as one grouped-conv pass (groups=2, one
    LayerNorm per half). Returns ([B, L], [B, L])."""
    m = mask[..., None].to(x.dtype)
    hidden = p_a["c1"]["w"].shape[-1]

    def grouped_conv(ca, cb, inp):
        w = {"w": torch.cat([ca["w"], cb["w"]], -1), "b": torch.cat([ca["b"], cb["b"]])}
        return layers.conv1d(w, inp, dtype=dtype, groups=2)

    def dual_layernorm(la, lb, h):
        h4 = h.reshape(h.shape[:-1] + (2, hidden)).float()
        mean = h4.mean(-1, keepdim=True)
        var = h4.var(-1, keepdim=True, unbiased=False)
        normed = (h4 - mean) * torch.rsqrt(var + 1e-5)
        gg = torch.stack([la["g"], lb["g"]])
        bb = torch.stack([la["b"], lb["b"]])
        return (normed * gg + bb).reshape(h.shape[:-1] + (2 * hidden,)).to(dtype)

    x2 = torch.cat([x * m, x * m], dim=-1)
    h = grouped_conv(p_a["c1"], p_b["c1"], x2)
    h = dual_layernorm(p_a["ln1"], p_b["ln1"], F.relu(h))
    h = h * m
    h = grouped_conv(p_a["c2"], p_b["c2"], h)
    h = dual_layernorm(p_a["ln2"], p_b["ln2"], F.relu(h))
    h4 = h.reshape(h.shape[:-1] + (2, hidden))
    w_out = torch.stack([p_a["out"]["w"][:, 0], p_b["out"]["w"][:, 0]]).to(dtype)  # [2, H]
    b_out = torch.stack([p_a["out"]["b"][0], p_b["out"]["b"][0]]).to(dtype)  # [2]
    out = torch.einsum("blgh,gh->blg", h4, w_out) + b_out
    mm = mask.to(dtype)
    return out[..., 0] * mm, out[..., 1] * mm


def _stack(
    p: Mapping, x: torch.Tensor, mask: torch.Tensor, cfg: ModelConfig, dtype,
    window=None, as_if_len=None,
) -> torch.Tensor:
    """Transformer stack dispatch: the fused kernel (`ops.transformer_stack`) when
    cfg.acoustic_pallas, else the plain layers. The choice depends on `as_if_len`
    (the one-shot frame count), never on the dispatch shape alone, so two-stage
    and one-shot (`tts.synthesize`) audio take the same numeric path."""
    if (
        cfg.acoustic_pallas
        and dtype in (torch.float32, torch.bfloat16)
        and x.shape[1] <= ts_op.MAX_T
        and (as_if_len or x.shape[1]) <= ts_op.MAX_T
        and cfg.conv_kernel == 3
    ):
        packed = layers.cached(
            p, ("transformer_stack", dtype, x.device), lambda: ts_op.pack_params(p, dtype)
        )
        return ts_op.transformer_stack(
            x, mask, packed, cfg.n_heads, window=window, bf16=(dtype == torch.bfloat16)
        ).to(dtype)
    return layers.transformer_stack(p, x, cfg.n_heads, mask, dtype, attention_window=window)


class AcousticModel(Tree):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.embed = layers.embedding_init(g, cfg.vocab_size, d)
        self.spk_proj = layers.dense_init(g, cfg.speaker_dim, d)
        self.encoder = layers.TransformerStack(
            g, cfg.encoder_layers, d, cfg.n_heads, cfg.d_ff, cfg.conv_kernel
        )
        self.dur_pred = predictor_init(g, d)
        self.pitch_pred = predictor_init(g, d)
        self.pitch_embed = layers.dense_init(g, 1, d)
        self.decoder = layers.TransformerStack(
            g, cfg.decoder_layers, d, cfg.n_heads, cfg.d_ff, cfg.conv_kernel
        )
        self.mel_out = layers.dense_init(g, d, cfg.n_mels)

    def forward(self, tokens, token_mask, speaker, exaggeration, dtype=torch.float32):
        return forward(self, tokens, token_mask, speaker, exaggeration, self.cfg, dtype=dtype)


def length_regulate(
    enc: torch.Tensor, durations: torch.Tensor, token_mask: torch.Tensor, max_frames: int
) -> Dict[str, torch.Tensor]:
    """Per-token encodings → per-frame encodings [B, max_frames, D]: frame t takes
    token j with cumsum(dur)[j-1] <= t < cumsum(dur)[j]."""
    durations = durations * token_mask.to(durations.dtype)
    cum = torch.cumsum(durations, dim=-1)  # [B, L]
    total = cum[:, -1]
    t_idx = torch.arange(max_frames, device=enc.device)[None, :, None]
    token_idx = (cum[:, None, :] <= t_idx).sum(-1).clamp(max=enc.shape[1] - 1)  # [B, T]
    frames = torch.gather(enc, 1, token_idx[..., None].expand(-1, -1, enc.shape[-1]))
    frame_mask = (torch.arange(max_frames, device=enc.device)[None, :] < total[:, None]).to(enc.dtype)
    return {
        "frames": frames * frame_mask[..., None],
        "frame_mask": frame_mask,
        "token_idx": token_idx,
        "total_frames": total,
    }


def encode(
    params: Mapping,
    tokens: torch.Tensor,  # [B, L] int
    token_mask: torch.Tensor,  # [B, L] 1 = valid
    speaker: torch.Tensor,  # [B, speaker_dim]
    exaggeration: torch.Tensor,  # [B]
    cfg: ModelConfig,
    durations: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    """Token-domain half: embedding → encoder → predictors → pitch conditioning.
    Replayed from a CUDA graph where the serving pass has one (`graphs.run`)."""
    inputs = (tokens, token_mask, speaker, exaggeration) + (() if durations is None else (durations,))
    return graphs.run(
        "acoustic.encode",
        lambda: _encode(params, tokens, token_mask, speaker, exaggeration, cfg, durations, dtype),
        params, inputs, id(cfg), dtype,
    )


def _encode(params, tokens, token_mask, speaker, exaggeration, cfg, durations, dtype):
    b, l = tokens.shape
    mask_f = token_mask.to(dtype)
    x = layers.embedding(params["embed"], tokens.long(), dtype)
    x = x + layers.positions_on(l, cfg.d_model, x.device).to(dtype)[None]
    spk = layers.dense(params["spk_proj"], speaker.to(dtype), dtype)  # [B, D]
    x = (x + spk[:, None, :]) * mask_f[..., None]

    enc = _stack(params["encoder"], x, token_mask, cfg, dtype)

    log_dur, pitch = predictors_apply_fused(
        params["dur_pred"], params["pitch_pred"], enc, token_mask, dtype
    )
    if durations is None:
        # torch.round, like jnp.round, rounds half to even.
        dur = torch.round(torch.exp(log_dur.float()) - 1.0)
        dur = torch.clamp(dur, 1.0, float(cfg.max_frames_per_token)).to(torch.int32)
        dur = dur * token_mask.to(torch.int32)
    else:
        dur = durations.to(torch.int32) * token_mask.to(torch.int32)

    denom = torch.clamp(mask_f.sum(-1, keepdim=True), min=1.0)
    pitch_mean = (pitch * mask_f).sum(-1, keepdim=True) / denom
    scale = (1.0 + exaggeration.to(dtype))[:, None]
    pitch_scaled = (pitch_mean + scale * (pitch - pitch_mean)) * mask_f
    enc = enc + layers.dense(params["pitch_embed"], pitch_scaled[..., None], dtype)
    enc = enc * mask_f[..., None]
    return {
        "enc": enc,
        "spk": spk,
        "durations": dur,
        "log_durations": log_dur,
        "pitch": pitch,
        "total_frames": torch.cumsum(dur, dim=-1)[:, -1].to(torch.int32),
    }


def decode(
    params: Mapping,
    enc: torch.Tensor,  # [B, L, D] from encode()
    spk: torch.Tensor,  # [B, D] from encode()
    durations: torch.Tensor,  # [B, L] int (masked)
    token_mask: torch.Tensor,  # [B, L]
    max_frames: int,
    cfg: ModelConfig,
    dtype=torch.float32,
    local_attention_from: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Frame-domain half: length regulate → decoder → mel. `local_attention_from`
    makes the local-vs-full attention (and kernel-vs-plain) choice as if the frame
    axis were that long, so a frame-bucketed dispatch matches the one-shot shape.
    Replayed from a CUDA graph where the serving pass has one (`graphs.run`)."""
    return graphs.run(
        "acoustic.decode",
        lambda: _decode(params, enc, spk, durations, token_mask, max_frames, cfg, dtype, local_attention_from),
        params, (enc, spk, durations, token_mask), max_frames, id(cfg), dtype, local_attention_from,
    )


def _decode(params, enc, spk, durations, token_mask, max_frames, cfg, dtype, local_attention_from):
    reg = length_regulate(enc, durations, token_mask, max_frames)
    dec_in = reg["frames"] + spk[:, None, :] * reg["frame_mask"][..., None]
    use_local = (
        cfg.decoder_attention_window is not None
        and (local_attention_from or max_frames) >= cfg.local_attention_min_frames
    )
    dec = _stack(
        params["decoder"], dec_in, reg["frame_mask"], cfg, dtype,
        window=cfg.decoder_attention_window if use_local else None,
        as_if_len=local_attention_from or max_frames,
    )
    mel = layers.dense(params["mel_out"], dec, dtype) * reg["frame_mask"][..., None]
    return {
        "mel": mel,
        "frame_mask": reg["frame_mask"],
        "total_frames": reg["total_frames"].to(torch.int32),
    }


def forward(
    params: Mapping,
    tokens: torch.Tensor,
    token_mask: torch.Tensor,
    speaker: torch.Tensor,
    exaggeration: torch.Tensor,
    cfg: ModelConfig,
    durations: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    e = encode(params, tokens, token_mask, speaker, exaggeration, cfg, durations=durations, dtype=dtype)
    d = decode(
        params, e["enc"], e["spk"], e["durations"], token_mask,
        tokens.shape[1] * cfg.max_frames_per_token, cfg, dtype=dtype,
    )
    return {
        "mel": d["mel"],
        "frame_mask": d["frame_mask"],
        "durations": e["durations"],
        "log_durations": e["log_durations"],
        "pitch": e["pitch"],
        "total_frames": d["total_frames"],
    }
