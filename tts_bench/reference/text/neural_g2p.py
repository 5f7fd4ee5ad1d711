"""Neural grapheme-to-phoneme serving: the char→ARPAbet seq2seq ensemble (two
192-d 3+3-layer and four 256-d 4+4-layer members) in a vectorized numpy beam
decoder, with the served frontend's vocabularies, weight loader and memo.

Weight files store the flattened parameter tree in JAX's flatten order (`p0`,
`p1`, ...): dict keys sorted, list order kept; `load_weights` rebuilds the tree by
that same walk.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional

import numpy as np
from .paths import DATA_DIR
from .symbols import PHONEMES, STRESSED_VOWELS



def sinusoidal_positions(length: int, dim: int, dtype=np.float32) -> np.ndarray:
    """Transformer sinusoidal position table [length, dim]."""
    pos = np.arange(length)[:, None].astype(np.float64)
    i = np.arange(dim // 2)[None, :].astype(np.float64)
    angles = pos / np.power(10000.0, 2 * i / dim)
    table = np.zeros((length, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(angles)
    table[:, 1::2] = np.cos(angles)
    return table.astype(dtype)


# ---------------------------------------------------------------- vocabularies

MAX_CHARS = 20
MAX_PHONS = 18  # includes EOS slot

_CHARS = "abcdefghijklmnopqrstuvwxyz'-"
CHAR_PAD = 0
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(_CHARS)}
N_CHAR_VOCAB = len(_CHARS) + 1

P_PAD, P_BOS, P_EOS = 0, 1, 2
# Stressed vowels APPENDED after the stressless set: every pre-stress id keeps
# its meaning, so the old vendored weights (42-way output) decode unchanged and
# stress-aware retrains (87-way) are a pure extension.
_ALL_PHONEMES = PHONEMES + STRESSED_VOWELS
_PHON_TO_ID = {p: i + 3 for i, p in enumerate(_ALL_PHONEMES)}
_ID_TO_PHON = {i + 3: p for i, p in enumerate(_ALL_PHONEMES)}
N_PHON_VOCAB = len(_ALL_PHONEMES) + 3

WEIGHTS_PATH = os.path.join(DATA_DIR, "g2p_weights.npz")


def encode_word(word: str) -> Optional[np.ndarray]:
    """word → padded char ids [MAX_CHARS], or None if unencodable."""
    ids = [_CHAR_TO_ID.get(c) for c in word.lower()]
    if not ids or any(i is None for i in ids) or len(ids) > MAX_CHARS:
        return None
    return np.asarray(ids + [CHAR_PAD] * (MAX_CHARS - len(ids)), np.int32)


def encode_phonemes(phons: List[str]) -> Optional[np.ndarray]:
    """phoneme list → padded target ids [MAX_PHONS] ending in EOS, or None."""
    ids = [_PHON_TO_ID.get(p) for p in phons]
    if not ids or any(i is None for i in ids) or len(ids) + 1 > MAX_PHONS:
        return None
    ids = ids + [P_EOS]
    return np.asarray(ids + [P_PAD] * (MAX_PHONS - len(ids)), np.int32)


def decode_ids(ids: np.ndarray) -> List[str]:
    out = []
    for i in ids.tolist():
        if i in (P_EOS, P_PAD):
            break
        out.append(_ID_TO_PHON.get(int(i), "AH"))
    return out


# ---------------------------------------------------------------- weights io

D_MODEL, N_HEADS, D_FF, ENC_LAYERS, DEC_LAYERS = 192, 4, 384, 3, 3

def _tree_skeleton(enc_layers: int = ENC_LAYERS, dec_layers: int = DEC_LAYERS) -> dict:
    """Same nested structure as init() with scalar placeholder leaves. Serving
    loads weights through this (tree_unflatten) so the first OOV word never pays
    init()'s ~30 XLA random-init compiles (measured 4-5 s on one CPU core; it was
    the dominant cost of the first frontend call and tripped service timeouts)."""
    ln = lambda: {"g": 0.0, "b": 0.0}
    dense = lambda: {"w": 0.0, "b": 0.0}
    mha = lambda: {"q": dense(), "k": dense(), "v": dense(), "o": dense()}
    ffn = lambda: {"w1": dense(), "w2": dense()}
    enc = lambda: {"ln1": ln(), "self": mha(), "ln2": ln(), "ffn": ffn()}
    dec = lambda: {
        "ln1": ln(), "self": mha(), "ln2": ln(), "cross": mha(), "ln3": ln(), "ffn": ffn()
    }
    return {
        "char_embed": {"table": 0.0},
        "phon_embed": {"table": 0.0},
        "enc": [enc() for _ in range(enc_layers)],
        "dec": [dec() for _ in range(dec_layers)],
        "ln_out": ln(),
        "out": dense(),
    }


def _flatten_order(tree) -> List[tuple]:
    """Leaf paths of `tree` in JAX's pytree flatten order: dict keys sorted, list
    entries in order."""
    if isinstance(tree, dict):
        return [(k,) + rest for k in sorted(tree) for rest in _flatten_order(tree[k])]
    if isinstance(tree, list):
        return [(i,) + rest for i, sub in enumerate(tree) for rest in _flatten_order(sub)]
    return [()]


def _set_path(tree, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def load_weights(path: str = WEIGHTS_PATH) -> dict:
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("p")])
        if "meta_layers" in data.files:
            enc_l, dec_l = (int(x) for x in data["meta_layers"])
        else:
            enc_l, dec_l = ENC_LAYERS, DEC_LAYERS  # pre-ensemble npz: fixed depth
        tree = _tree_skeleton(enc_l, dec_l)
        paths = _flatten_order(tree)
        if len(paths) != n:
            raise ValueError(f"{path}: {n} weight arrays, expected {len(paths)}")
        for i, leaf_path in enumerate(paths):
            _set_path(tree, leaf_path, np.asarray(data[f"p{i}"], np.float32))
    return tree

# ---------------------------------------------------------------- numpy inference
# A dependency-free numpy forward pass: no backend assumptions, microsecond-scale
# for one word. Equality with the JAX frontend is pinned by tests/test_torch_text.py.


def _np_ln(p, x):
    g, b = np.asarray(p["g"], np.float32), np.asarray(p["b"], np.float32)
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + 1e-5) * g + b


def _np_dense(p, x):
    return x @ np.asarray(p["w"], np.float32) + np.asarray(p["b"], np.float32)


def _np_softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _np_attn(p, q_in, kv_in, key_mask=None, causal=False):
    tq, d = q_in.shape
    tk = kv_in.shape[0]
    h, dh = N_HEADS, d // N_HEADS
    q = _np_dense(p["q"], q_in).reshape(tq, h, dh)
    k = _np_dense(p["k"], kv_in).reshape(tk, h, dh)
    v = _np_dense(p["v"], kv_in).reshape(tk, h, dh)
    logits = np.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
    if key_mask is not None:
        logits = logits + np.where(key_mask[None, None, :] > 0, 0.0, -1e9)
    if causal:
        logits = logits + np.where(np.tril(np.ones((tq, tk), bool))[None], 0.0, -1e9)
    out = np.einsum("hqk,khd->qhd", _np_softmax(logits), v).reshape(tq, d)
    return _np_dense(p["o"], out)


def _np_attn_b(p, q_in, kv_in, key_mask=None, causal=False):
    """Batched attention: q_in [B,Tq,D]; kv_in [B,Tk,D] or broadcastable [Tk,D];
    key_mask [Tk] (shared) or [B,Tk] (per example). The beam decoder batches
    every live hypothesis of every word into ONE call per step — on a 1-core
    host this is the difference between ~250 ms and ~5 ms per OOV word."""
    b, tq, d = q_in.shape
    if kv_in.ndim == 2:
        kv_in = np.broadcast_to(kv_in, (b,) + kv_in.shape)
    tk = kv_in.shape[1]
    h, dh = N_HEADS, d // N_HEADS
    q = _np_dense(p["q"], q_in).reshape(b, tq, h, dh)
    k = _np_dense(p["k"], kv_in).reshape(b, tk, h, dh)
    v = _np_dense(p["v"], kv_in).reshape(b, tk, h, dh)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if key_mask is not None:
        km = key_mask[None, :] if key_mask.ndim == 1 else key_mask
        logits = logits + np.where(km[:, None, None, :] > 0, 0.0, -1e9)
    if causal:
        logits = logits + np.where(
            np.tril(np.ones((tq, tk), bool))[None, None], 0.0, -1e9
        )
    out = np.einsum("bhqk,bkhd->bqhd", _np_softmax(logits), v).reshape(b, tq, d)
    return _np_dense(p["o"], out)


def _np_ffn(p, x):
    return _np_dense(p["w2"], np.maximum(_np_dense(p["w1"], x), 0.0))


def _prepare(params):
    """One-time pairing of the (float32 numpy) weight tree with the two
    sinusoidal position tables — pure functions of the loaded weights that the
    serving path must not recompute per OOV word."""
    d_model = params["char_embed"]["table"].shape[1]
    return (
        params,
        sinusoidal_positions(MAX_CHARS, d_model),
        sinusoidal_positions(MAX_PHONS, d_model),
    )


# Words per inner decode batch: bounds the KV-cache memory (~N·2.3 MB across
# the vendored ensemble) while keeping every matmul big enough to amortize
# numpy dispatch on the 1-core serving host.
_PREDICT_CHUNK = 128


def _np_predict_batch(bundles, chars_b: np.ndarray, beam: int = 1) -> np.ndarray:
    """chars_b [N, MAX_CHARS] int32 → phoneme ids [N, MAX_PHONS].

    Length-normalized beam search over ALL words at once, with INCREMENTAL
    decoding: per step each member computes only the newest position's
    activations against per-layer self-attention K/V caches and cross-attention
    K/V precomputed once from the encoder — O(T) dense work per hypothesis
    instead of the O(T²) full-prefix recompute. Identical math (a position's
    activations never depend on later positions), so greedy stays parity-exact
    with the jax decoder. On the 1-core serving host this cuts a cold OOV word
    from ~350 ms to ~120-190 ms at 4 members × beam 4 (~60 ms/word batched; the
    remaining cost is the ensemble's ~1.5 GFLOP/word — FLOP-bound, measured by
    profile, so further wins need fewer/smaller members, not code motion).

    beam=1 is exact greedy (parity-tested against the jax decoder). Hypothesis
    scores normalize by the number of summed log-prob terms (EOS included), so
    finished hypotheses stay comparable with unfinished ones. Candidate policy
    matches the historical per-word decoder: top-`beam` expansions per live
    hypothesis, merged with carried-over finished hypotheses, pruned to `beam`.
    Batches beyond _PREDICT_CHUNK words decode in chunks (bounds cache memory)."""
    n_all = chars_b.shape[0]
    if n_all > _PREDICT_CHUNK:
        return np.concatenate(
            [
                _np_predict_batch(bundles, chars_b[i : i + _PREDICT_CHUNK], beam=beam)
                for i in range(0, n_all, _PREDICT_CHUNK)
            ],
            axis=0,
        )
    n_words = n_all
    k = beam
    h = N_HEADS
    masks = (chars_b != CHAR_PAD).astype(np.float32)  # [N, Tc]
    # Per member: cross-attention K/V per decoder layer (encoder is fixed for
    # the whole decode — projecting it once removes the per-step enc k/v dense,
    # the single largest recompute in the old full-prefix decoder) and zeroed
    # self-attention K/V caches [N, k, MAX_PHONS, h, dh].
    cross_kv = []
    caches = []
    for p, pos_c, _ in bundles:
        x = p["char_embed"]["table"][chars_b] + pos_c
        for blk in p["enc"]:
            nrm = _np_ln(blk["ln1"], x)
            x = x + _np_attn_b(blk["self"], nrm, nrm, key_mask=masks)
            x = x + _np_ffn(blk["ffn"], _np_ln(blk["ln2"], x))
        d = x.shape[-1]
        dh = d // h
        ckv = []
        mcache = []
        for blk in p["dec"]:
            ckv.append(
                (
                    _np_dense(blk["cross"]["k"], x).reshape(n_words, -1, h, dh),
                    _np_dense(blk["cross"]["v"], x).reshape(n_words, -1, h, dh),
                )
            )
            mcache.append(
                (
                    np.zeros((n_words, k, MAX_PHONS, h, dh), np.float32),
                    np.zeros((n_words, k, MAX_PHONS, h, dh), np.float32),
                )
            )
        cross_kv.append(ckv)
        caches.append(mcache)

    NEG = -1e30
    # Hypothesis state [N, k]: slot 0 is the lone BOS hypothesis at t=0.
    ids = np.full((n_words, k, 1 + MAX_PHONS), P_PAD, np.int32)
    ids[:, :, 0] = P_BOS
    length = np.ones((n_words, k), np.int32)  # ids length incl BOS
    sumlp = np.full((n_words, k), NEG, np.float64)
    sumlp[:, 0] = 0.0
    nterms = np.zeros((n_words, k), np.int64)
    done = np.zeros((n_words, k), bool)
    valid = np.zeros((n_words, k), bool)
    valid[:, 0] = True
    wi = np.arange(n_words)[:, None]

    for t in range(MAX_PHONS):
        live = valid & ~done
        if not live.any():
            break
        rows = np.nonzero(live.reshape(-1))[0]
        word_of = rows // k
        slot_of = rows % k
        # Every live hypothesis at step t has exactly t+1 tokens (extended every
        # step since BOS), so the new position index is uniformly t.
        tok_t = ids.reshape(n_words * k, -1)[rows, t]
        mask_rows = masks[word_of]  # [R, Tc]
        acc = None
        for (p, _, pos_p), ckv, mcache in zip(bundles, cross_kv, caches):
            d = p["char_embed"]["table"].shape[1]
            dh = d // h
            y = p["phon_embed"]["table"][tok_t] + pos_p[t]  # [R, D]
            for blk, (kc, vc), (K, V) in zip(p["dec"], ckv, mcache):
                nrm = _np_ln(blk["ln1"], y)
                q = _np_dense(blk["self"]["q"], nrm).reshape(-1, h, dh)
                K[word_of, slot_of, t] = _np_dense(blk["self"]["k"], nrm).reshape(
                    -1, h, dh
                )
                V[word_of, slot_of, t] = _np_dense(blk["self"]["v"], nrm).reshape(
                    -1, h, dh
                )
                ka = K[word_of, slot_of, : t + 1]  # [R, t+1, h, dh]
                va = V[word_of, slot_of, : t + 1]
                w8 = _np_softmax(np.einsum("rhd,rkhd->rhk", q, ka) / math.sqrt(dh))
                y = y + _np_dense(
                    blk["self"]["o"],
                    np.einsum("rhk,rkhd->rhd", w8, va).reshape(-1, d),
                )
                nrm = _np_ln(blk["ln2"], y)
                q = _np_dense(blk["cross"]["q"], nrm).reshape(-1, h, dh)
                lo = np.einsum("rhd,rkhd->rhk", q, kc[word_of]) / math.sqrt(dh)
                lo = lo + np.where(mask_rows[:, None, :] > 0, 0.0, -1e9)
                y = y + _np_dense(
                    blk["cross"]["o"],
                    np.einsum(
                        "rhk,rkhd->rhd", _np_softmax(lo), vc[word_of]
                    ).reshape(-1, d),
                )
                y = y + _np_ffn(blk["ffn"], _np_ln(blk["ln3"], y))
            logits = _np_dense(p["out"], _np_ln(p["ln_out"], y))  # [R, V]
            m = logits.max(-1, keepdims=True)
            lp = logits - np.log(np.exp(logits - m).sum(-1, keepdims=True)) - m
            acc = lp if acc is None else acc + lp
        logp = acc / len(bundles)  # [R, V]
        if k == 1:
            top_tok = np.argmax(logp, axis=1)  # [R]
            top_lp = logp[np.arange(len(rows)), top_tok]
        else:
            top_tok = np.argpartition(-logp, k - 1, axis=1)[:, :k]  # [R, k]
            top_lp = np.take_along_axis(logp, top_tok, axis=1)

        # Per-word candidate merge (small python loop over live words only —
        # the heavy math above is fully batched). `src` records each surviving
        # slot's source slot so the K/V caches can be reordered to match.
        src = np.zeros((n_words, k), np.int64)
        row_of_word = {}
        for ri, w in enumerate(word_of):
            row_of_word.setdefault(int(w), []).append(ri)
        for w, ris in row_of_word.items():
            cands = []  # (norm, sum, nterms, src_slot, tok_or_None, done)
            for s in range(k):
                if valid[w, s] and done[w, s]:
                    cands.append(
                        (sumlp[w, s] / max(nterms[w, s], 1), sumlp[w, s],
                         nterms[w, s], s, None, True)
                    )
            for ri in ris:
                s = int(rows[ri] % k)
                toks = [int(top_tok[ri])] if k == 1 else [int(x) for x in top_tok[ri]]
                lps = [float(top_lp[ri])] if k == 1 else [float(x) for x in top_lp[ri]]
                for tok, tlp in zip(toks, lps):
                    ns = sumlp[w, s] + tlp
                    nt = nterms[w, s] + 1
                    if tok in (P_EOS, P_PAD):
                        cands.append((ns / max(nt, 1), ns, nt, s, None, True))
                    else:
                        # Reserve the final slot for EOS: cap at MAX_PHONS-1 tokens.
                        fin = (length[w, s] + 1) - 1 >= MAX_PHONS - 1
                        cands.append((ns / max(nt, 1), ns, nt, s, tok, fin))
            cands.sort(key=lambda c: c[0], reverse=True)
            cands = cands[:k]
            new_ids = np.full((k, 1 + MAX_PHONS), P_PAD, np.int32)
            new_ids[:, 0] = P_BOS
            new_len = np.ones(k, np.int32)
            new_sum = np.full(k, NEG, np.float64)
            new_nt = np.zeros(k, np.int64)
            new_done = np.zeros(k, bool)
            new_valid = np.zeros(k, bool)
            for j, (_, ns, nt, s, tok, fin) in enumerate(cands):
                ln = int(length[w, s])
                new_ids[j, :ln] = ids[w, s, :ln]
                if tok is not None:
                    new_ids[j, ln] = tok
                    ln += 1
                new_len[j] = ln
                new_sum[j] = ns
                new_nt[j] = nt
                new_done[j] = fin
                new_valid[j] = True
                src[w, j] = s
            ids[w], length[w], sumlp[w] = new_ids, new_len, new_sum
            nterms[w], done[w], valid[w] = new_nt, new_done, new_valid
        if k > 1:
            # Reorder the self-attention caches to follow the surviving slots
            # (greedy never reshuffles: the lone slot always descends from
            # itself, so the gather is skipped).
            for mcache in caches:
                for li, (K, V) in enumerate(mcache):
                    mcache[li] = (K[wi, src], V[wi, src])

    out = np.full((n_words, MAX_PHONS), P_PAD, np.int32)
    norm = np.where(valid, sumlp / np.maximum(nterms, 1), NEG)
    best = np.argmax(norm, axis=1)
    for w in range(n_words):
        s = int(best[w])
        ln = int(length[w, s])
        toks = [int(x) for x in ids[w, s, 1:ln]]
        seq = toks + [P_EOS]
        out[w, : len(seq)] = np.asarray(seq[:MAX_PHONS], np.int32)
    return out


def _np_predict(params, chars: np.ndarray, beam: int = 1, prepared=None) -> np.ndarray:
    """Single-word wrapper over _np_predict_batch (kept for the jax-parity test
    and any older callers). `prepared` may be one _prepare bundle or a list of
    them (ensemble)."""
    if isinstance(prepared, list):
        bundles = prepared
    else:
        bundles = [prepared if prepared is not None else _prepare(params)]
    return _np_predict_batch(bundles, np.asarray(chars, np.int32)[None], beam=beam)[0]


# Stress-marginalized scoring groups: for each STRESSLESS phoneme, the output
# ids whose probability mass means "this phoneme" — the plain id plus every
# stressed variant (stress-aware members put most vowel mass on the stressed
# ids, so scoring a stressless candidate against the plain id alone would
# systematically under-score it).
_BASE_GROUP_IDS: Dict[str, List[int]] = {
    p: [_PHON_TO_ID[p]] + [_PHON_TO_ID[v] for v in STRESSED_VOWELS if v[:-1] == p]
    for p in PHONEMES
}


def _np_score_batch(bundles, chars_b: np.ndarray, tgt_rows: List[List[List[int]]]) -> np.ndarray:
    """Teacher-forced ensemble log-prob of given STRESSLESS pronunciations.

    chars_b [N, MAX_CHARS]; tgt_rows[i] = per-position id-groups for row i
    (each group = the ids to marginalize over: a phoneme's plain+stressed ids,
    ending with the [P_EOS] group). Returns mean-per-token log-prob [N] under
    the member-averaged distribution — the SAME normalization the beam decoder
    ranks hypotheses by, so scores are comparable with decoded candidates'."""
    n = chars_b.shape[0]
    t = max(len(r) for r in tgt_rows)
    masks = (chars_b != CHAR_PAD).astype(np.float32)
    # Decoder input: BOS then the (stressless) target ids shifted right. Using
    # the plain ids as history is the natural conditioning for a stressless
    # candidate; the marginalization applies to the OUTPUT distribution.
    dec_in = np.full((n, t), P_PAD, np.int32)
    dec_in[:, 0] = P_BOS
    for i, row in enumerate(tgt_rows):
        for j, grp in enumerate(row[:-1]):  # history excludes the EOS slot
            dec_in[i, j + 1] = grp[0]
    probs = None
    for p, pos_c, pos_p in bundles:
        x = p["char_embed"]["table"][chars_b] + pos_c
        for blk in p["enc"]:
            nrm = _np_ln(blk["ln1"], x)
            x = x + _np_attn_b(blk["self"], nrm, nrm, key_mask=masks)
            x = x + _np_ffn(blk["ffn"], _np_ln(blk["ln2"], x))
        y = p["phon_embed"]["table"][dec_in] + pos_p[:t]
        for blk in p["dec"]:
            nrm = _np_ln(blk["ln1"], y)
            y = y + _np_attn_b(blk["self"], nrm, nrm, causal=True)
            y = y + _np_attn_b(
                blk["cross"], _np_ln(blk["ln2"], y), x, key_mask=masks
            )
            y = y + _np_ffn(blk["ffn"], _np_ln(blk["ln3"], y))
        logits = _np_dense(p["out"], _np_ln(p["ln_out"], y))  # [N, T, V]
        m = logits.max(-1, keepdims=True)
        lp = logits - np.log(np.exp(logits - m).sum(-1, keepdims=True)) - m
        # The beam averages LOG-probs across members; match it exactly.
        probs = lp if probs is None else probs + lp
    lp = probs / len(bundles)  # [N, T, V]
    out = np.zeros(n, np.float64)
    for i, row in enumerate(tgt_rows):
        s = 0.0
        for j, grp in enumerate(row):
            g = lp[i, j, grp]
            mx = g.max()
            s += mx + math.log(np.exp(g - mx).sum())
        out[i] = s / max(len(row), 1)
    return out


def score_pronunciations(
    word: str, candidates: List[List[str]]
) -> List[Optional[float]]:
    """Mean-per-token ensemble log-prob of each stressless `candidates` entry
    for `word` (None where the word/candidate is unencodable). Used by the
    frontend's morph-vs-neural arbitration: a morph decomposition whose
    pronunciation the ensemble finds wildly improbable is usually a wrong
    split (tools/g2p_eval.py measures the net effect on the held-out split)."""
    models = _get_models()
    chars = encode_word(word)
    if models is None or chars is None:
        return [None] * len(candidates)
    rows, keep = [], []
    for ci, cand in enumerate(candidates):
        grps = [_BASE_GROUP_IDS.get(p) for p in cand]
        if not grps or any(g is None for g in grps) or len(grps) + 1 > MAX_PHONS:
            continue
        rows.append(grps + [[P_EOS]])
        keep.append(ci)
    out: List[Optional[float]] = [None] * len(candidates)
    if rows:
        scores = _np_score_batch(
            models, np.broadcast_to(chars, (len(rows), MAX_CHARS)), rows
        )
        for ci, s in zip(keep, scores):
            out[ci] = float(s)
    return out


# ---------------------------------------------------------------- serving path

_LOCK = threading.Lock()
# Word-result memo and the loaded-weights slot are SEPARATE: a words dict keyed by
# input word must never share a namespace with bookkeeping keys (the English word
# "params" is a legitimate input). Bounded: client-controlled text can contain
# unlimited unique OOV words, so the memo evicts oldest-inserted past the cap
# (plain dict preserves insertion order) like the other serving-path caches.
_WORD_CACHE: Dict[str, Optional[List[str]]] = {}
_WORD_CACHE_MAX = 4096
# Loaded-model slot: empty = not yet loaded; [None] = unavailable;
# [[(params, pos_c, pos_p), ...]] = prepared ensemble bundles. ONE slot holds
# both params and their prepared form so clearing _PARAMS (tests do) can never
# leave a stale prepared bundle behind.
_PARAMS: List[object] = []


def _ensemble_paths() -> List[str]:
    """The vendored weights plus any ensemble siblings (_e2.npz, _e3.npz, ...)
    next to them. Member count is whatever is shipped; decode cost scales
    linearly with members (a cold OOV word is ~0.2 s at the vendored 6 on the
    1-core host, then memoized — see _np_predict_batch)."""
    root, ext = os.path.splitext(WEIGHTS_PATH)
    out = [WEIGHTS_PATH]
    for i in range(2, 9):
        p = f"{root}_e{i}{ext}"
        if os.path.exists(p):
            out.append(p)
    return out


def available() -> bool:
    if os.environ.get("TTS_NEURAL_G2P", "1") == "0":
        return False
    return os.path.exists(WEIGHTS_PATH)


def _get_models() -> Optional[List[tuple]]:
    with _LOCK:
        if not _PARAMS:
            if available():
                _PARAMS.append([_prepare(load_weights(p)) for p in _ensemble_paths()])
            else:
                _PARAMS.append(None)
        return _PARAMS[0]


def _beam_width() -> int:
    try:
        beam = int(os.environ.get("TTS_G2P_BEAM", "4"))
    except ValueError:
        beam = 4
    return max(1, beam)  # 0/negative used to crash the decoder (argsort[-0:])


def predict_words(words: List[str]) -> Dict[str, Optional[List[str]]]:
    """Batched neural pronunciations: ONE vectorized beam decode for every
    un-memoized encodable word in `words`. The per-word path delegates here;
    eval harnesses push hundreds of words per call (seconds for the whole
    held-out split on one core, vs minutes word-at-a-time)."""
    models = _get_models()
    out: Dict[str, Optional[List[str]]] = {}
    if models is None:
        return {w: None for w in words}
    todo, chars_list = [], []
    with _LOCK:
        for w in words:
            key = w.lower()
            if key in _WORD_CACHE:
                out[w] = _WORD_CACHE[key]
            elif key not in todo:
                todo.append(key)
    for key in list(todo):
        c = encode_word(key)
        if c is None:
            todo.remove(key)
            out[key] = None
        else:
            chars_list.append(c)
    if todo:
        beam = _beam_width()
        # Chunked: one huge batch (1000+ words × beam hypotheses) thrashes the
        # allocator; ~64 words keeps every step's arrays cache-sized.
        CHUNK = 64
        for lo in range(0, len(todo), CHUNK):
            keys = todo[lo : lo + CHUNK]
            ids = _np_predict_batch(
                models,
                np.stack(chars_list[lo : lo + CHUNK]).astype(np.int32),
                beam=beam,
            )
            with _LOCK:
                for key, row in zip(keys, ids):
                    phons = decode_ids(row) or None
                    while len(_WORD_CACHE) >= _WORD_CACHE_MAX:
                        _WORD_CACHE.pop(next(iter(_WORD_CACHE)))
                    _WORD_CACHE[key] = phons
                    out[key] = phons
    return {w: out.get(w, out.get(w.lower())) for w in words}


def predict_word(word: str) -> Optional[List[str]]:
    """Neural pronunciation for one word, or None when unavailable/unencodable.
    Results are memoized (serving calls this per OOV word)."""
    return predict_words([word])[word]