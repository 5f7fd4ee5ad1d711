"""Alignment learning: text↔mel aligner with monotonic alignment search (MAS).

Counterpart of `gonova_tts_tpu/models/aligner.py`, which explains the design: a
per-token MLP predicts a mel-space prototype per token; the frame query is the
CMN-normalized short-window mel frame itself; the score is the negative
temperature-scaled squared distance plus a learnable normalized-position
diagonal term, log-softmax-normalized over tokens per frame. `forward_sum_loss`
(the differentiable sum over all monotonic paths) trains the prototypes;
`mas_durations` (Viterbi over the same scores) extracts hard per-token durations
for the duration predictor and the length regulator.

Both recursions are loops over the frame axis with the token axis vectorized
([B, L] a step), as the JAX `lax.scan`s are; autograd runs through the
forward sum. Padding scores are the finite `_NEG_INF`, never -inf: `logaddexp`
of two true -inf has a NaN gradient. The two losses' batch reductions go through
`tp.global_sum`, so under the sharded step they are the whole batch's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..parallel.tp import global_mean, global_sum
from . import layers
from .layers import Tree

_NEG_INF = -1e9


def init(g: torch.Generator, cfg: ModelConfig, dim: int = 128) -> Tree:
    """Token→mel-prototype head: a per-token MLP (kernel-1 convs) over its own
    token embedding, a learnable distance temperature `temp` and diagonal
    coefficient `diag` (both softplus'd in `log_probs`)."""
    node = layers.leaf(temp=torch.tensor(1.0), diag=torch.tensor(100.0))
    node.add_module("embed", layers.embedding_init(g, cfg.vocab_size, dim))
    node.add_module("t_c1", layers.conv1d_init(g, dim, dim, 1))
    node.add_module("t_c2", layers.conv1d_init(g, dim, cfg.n_mels, 1))
    return node


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """One-hot by comparison: an index outside [0, n) gives a zero row, as
    `jax.nn.one_hot` does (a padded row has l_valid - 1 = -1)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def diagonal_prior(
    token_mask: torch.Tensor,  # [B, L]
    frame_mask: torch.Tensor,  # [B, T]
    sigma: float = 0.12,
) -> torch.Tensor:
    """Static near-diagonal alignment prior, log-space, [B, T, L]: a Gaussian in
    normalized coordinates, -0.5 * ((t+.5)/T_b - (j+.5)/L_b)^2 / sigma^2."""
    l_valid = torch.clamp(token_mask.sum(-1), min=1.0)
    t_valid = torch.clamp(frame_mask.sum(-1), min=1.0)
    dev = token_mask.device
    t_pos = (torch.arange(frame_mask.shape[1], device=dev)[None, :] + 0.5) / t_valid[:, None]
    j_pos = (torch.arange(token_mask.shape[1], device=dev)[None, :] + 0.5) / l_valid[:, None]
    d = t_pos[:, :, None] - j_pos[:, None, :]
    return -0.5 * (d / sigma) ** 2


def log_probs(
    p: Mapping,
    tokens: torch.Tensor,  # [B, L] int
    mel: torch.Tensor,  # [B, T, n_mels]
    token_mask: torch.Tensor,  # [B, L]
    dtype=torch.float32,
    prior: Optional[torch.Tensor] = None,  # [B, T, L] log-space, optional
    frame_mask: Optional[torch.Tensor] = None,  # [B, T]; None = all frames valid
) -> torch.Tensor:
    """log p(token j | frame t): [B, T, L], log-softmax over valid tokens."""
    keys = layers.embedding(p["embed"], tokens.long(), dtype)
    keys = layers.conv1d(p["t_c1"], keys, dtype=dtype)
    keys = layers.conv1d(p["t_c2"], torch.relu(keys), dtype=dtype)  # [B, L, n_mels]
    dev = mel.device
    fm = torch.ones(mel.shape[:2], dtype=dtype, device=dev) if frame_mask is None else frame_mask.to(dtype)
    denom = torch.clamp(fm.sum(1, keepdim=True), min=1.0)[..., None]
    cmn = (mel.to(dtype) * fm[:, :, None]).sum(1, keepdim=True) / denom
    q = mel.to(dtype) - cmn  # [B, T, n_mels]
    # ||q - k||^2 / n_mels by the expanded form: no [B, T, L, n_mels] tensor.
    qq = (q * q).sum(-1)[:, :, None]
    kk = (keys * keys).sum(-1)[:, None, :]
    qk = torch.einsum("btd,bld->btl", q, keys)
    dist = (qq - 2.0 * qk + kk) / q.shape[-1]
    scores = -F.softplus(p["temp"]).to(dtype) * dist
    l_valid = torch.clamp(token_mask.sum(-1), min=1.0)
    if frame_mask is None:
        t_valid = torch.full((tokens.shape[0],), float(mel.shape[1]), device=dev)
    else:
        t_valid = torch.clamp(frame_mask.sum(-1), min=1.0)
    t_pos = (torch.arange(mel.shape[1], device=dev)[None, :] + 0.5) / t_valid[:, None]
    j_pos = (torch.arange(tokens.shape[1], device=dev)[None, :] + 0.5) / l_valid[:, None]
    d = (t_pos[:, :, None] - j_pos[:, None, :]).to(scores.dtype)
    scores = scores - F.softplus(p["diag"]).to(scores.dtype) * d * d
    if prior is not None:
        scores = scores + prior.to(scores.dtype)
    scores = torch.where(token_mask[:, None, :] > 0, scores, torch.full_like(scores, _NEG_INF))
    return torch.log_softmax(scores.float(), dim=-1)


def _padded_log_p(
    log_p: torch.Tensor, token_mask: torch.Tensor, frame_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rewrite padding so the fixed-shape recursions end at (T_b-1, L_b-1): past
    a row's last real frame only its last valid token is allowed (score 0), and
    the last real frame itself is held to that token, so a path cannot defer its
    arrival at L_b-1 into the padded tail."""
    l_valid = token_mask.sum(-1).to(torch.int64)
    t_valid = frame_mask.sum(-1).to(torch.int64)
    L = log_p.shape[-1]
    last_tok = _one_hot(l_valid - 1, L, log_p.dtype)  # [B, L]
    neg = torch.full_like(log_p, _NEG_INF)
    pad_row = torch.where(last_tok > 0, 0.0, _NEG_INF).to(log_p.dtype)  # [B, L]
    t_idx = torch.arange(log_p.shape[1], device=log_p.device)[None, :]
    is_end = (t_idx == (t_valid - 1)[:, None])[:, :, None]  # [B, T, 1]
    log_p = torch.where(is_end & (last_tok[:, None, :] == 0), neg, log_p)
    live = frame_mask[:, :, None] > 0
    return torch.where(live, log_p, pad_row[:, None, :].expand_as(log_p)), l_valid, t_valid


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """[B, L] → [B, L] with x[:, j-1] at j and _NEG_INF at 0."""
    return F.pad(x[:, :-1], (1, 0), value=_NEG_INF)


def forward_sum_loss(
    log_p: torch.Tensor,  # [B, T, L] from log_probs
    token_mask: torch.Tensor,
    frame_mask: torch.Tensor,
) -> torch.Tensor:
    """-log sum over monotonic alignments (CTC-like), mean over batch, per frame:
    alpha[t, j] = log_p[t, j] + logaddexp(alpha[t-1, j], alpha[t-1, j-1]);
    loss_b = -alpha[T_b-1, L_b-1] / T_b."""
    log_p, l_valid, t_valid = _padded_log_p(log_p, token_mask, frame_mask)
    b, t_max, l_max = log_p.shape
    first = _one_hot(torch.zeros(b, dtype=torch.int64, device=log_p.device), l_max) > 0
    alpha = torch.where(first, log_p[:, 0, :1], torch.full_like(log_p[:, 0], _NEG_INF))
    for t in range(1, t_max):
        alpha = log_p[:, t] + torch.logaddexp(alpha, _shift_right(alpha))
    final = (alpha * _one_hot(l_valid - 1, l_max)).sum(-1)
    return global_mean(-final / torch.clamp(t_valid.float(), min=1.0))


def mas_durations(
    log_p: torch.Tensor,  # [B, T, L]; hard targets: pass a detached tensor
    token_mask: torch.Tensor,
    frame_mask: torch.Tensor,
) -> torch.Tensor:
    """Viterbi monotonic alignment → per-token durations [B, L] int32.

    Forward: best[t, j] = log_p[t, j] + max(best[t-1, j], best[t-1, j-1]), with
    the choice recorded (advance only when strictly better: ties stay). Backward:
    from (T-1, L_b-1), j -= choice[t][j]. Durations count real frames only."""
    with torch.no_grad():
        log_p, l_valid, t_valid = _padded_log_p(log_p, token_mask, frame_mask)
        b, t_max, l_max = log_p.shape
        first = _one_hot(torch.zeros(b, dtype=torch.int64, device=log_p.device), l_max) > 0
        best = torch.where(first, log_p[:, 0, :1], torch.full_like(log_p[:, 0], _NEG_INF))
        choices = []
        for t in range(1, t_max):
            prev = _shift_right(best)
            advance = prev > best
            best = log_p[:, t] + torch.where(advance, prev, best)
            choices.append(advance)
        j = l_valid - 1  # [B]; the path ends at the last valid token
        path = [j]
        for adv_t in reversed(choices):
            took = torch.gather(adv_t, 1, j.clamp(min=0)[:, None])[:, 0] & (j >= 0)
            j = j - took.to(j.dtype)
            path.append(j)
        path = torch.stack(path[::-1], dim=1)  # [B, T] token per frame
        onehot = _one_hot(path, l_max)
        dur = (onehot * frame_mask[:, :, None]).sum(1)
        return dur.to(torch.int32)


def _token_index(durations: torch.Tensor, t_max: int) -> torch.Tensor:
    """[B, T] token index of each frame under `durations` (clamped to L - 1)."""
    cum = torch.cumsum(durations, dim=-1)
    t_idx = torch.arange(t_max, device=durations.device)[None, :, None]
    return (cum[:, None, :] <= t_idx).sum(-1).clamp(max=durations.shape[-1] - 1)


def bin_loss(
    log_p: torch.Tensor,  # [B, T, L]
    durations: torch.Tensor,  # [B, L] int (MAS output)
    frame_mask: torch.Tensor,
) -> torch.Tensor:
    """-mean log p along the hard path (RAD-TTS' binarization term)."""
    token_idx = _token_index(durations, log_p.shape[1])
    onpath = torch.gather(log_p, 2, token_idx[:, :, None])[..., 0]
    denom = torch.clamp(global_sum(frame_mask.sum()), min=1.0)
    return -global_sum((onpath * frame_mask).sum()) / denom


def token_pitch(
    pitch_frames: torch.Tensor,  # [B, T]
    durations: torch.Tensor,  # [B, L]
    frame_mask: torch.Tensor,
) -> torch.Tensor:
    """Per-token mean of a frame-level feature under the given segmentation,
    [B, L] (pitch targets re-pooled under the MAS durations)."""
    token_idx = _token_index(durations, pitch_frames.shape[1])
    onehot = _one_hot(token_idx, durations.shape[-1]) * frame_mask[:, :, None]
    sums = torch.einsum("btl,bt->bl", onehot, pitch_frames)
    counts = onehot.sum(1)
    return sums / torch.clamp(counts, min=1.0)


def diagnostics(
    log_p: torch.Tensor, durations: torch.Tensor, frame_mask: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Aligner health: mean on-path probability (confidence)."""
    return {"align_conf": torch.exp(-bin_loss(log_p, durations, frame_mask))}
