"""Train one neural G2P member (text/neural_g2p.py) on the vendored lexicon.

The port's copy of the JAX package's tools/train_g2p.py: the same data (every
lexicon entry NOT in the deterministic crc32 % 10 == 0 held-out split that
tools/g2p_eval.py grades, plus regular morphological derivations and, optionally,
sampled two-word compounds; rule-derived stress marks), the same batches
(`np.random.default_rng(seed).integers(0, n, size=min(batch, n))` each step), the
same loss (label-smoothed cross entropy over all V classes, masked on P_PAD, over
max(#targets, 1)) and optax's `adamw(warmup_cosine_decay_schedule(0, lr,
min(200, max(1, steps // 10)), steps, 0.02 * lr), weight_decay=wd)`: b1 0.9, b2
0.999, eps 1e-8, decay on every leaf, no clip, and update 0 at learning rate 0.
Then the held-out report (greedy decoding, stressless and stressed, and the LTS
baseline) and float16 weights in JAX's format, which both packages' `load_weights`
read.

    python -m gonova_tts_tpu_torch.tools.train_g2p [--steps 4000] [--device cpu] [--no-save]

Runs on CUDA unless `--device cpu`. The weights go to `--save-path`, by default
build/g2p/g2p_weights.npz (git-ignored), never into the vendored data directory:
to serve a member, put the file in place of (or beside, as `_e<N>.npz`) the
vendored ones yourself.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops._build import BUILD
from ..text import neural_g2p as ng
from ..text.g2p import LEXICON, VENDORED_LEXICON, _word_to_phonemes_lts
from ..text.stress import assign_stress, strip_stress
from .g2p_eval import grade

SAVE_PATH = os.path.join(BUILD, "g2p", "g2p_weights.npz")


_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}
_VOWELS = set("aeiou")


def _cvc_risky(w: str) -> bool:
    """Final-consonant doubling territory (stop→stopping): skip rather than guess."""
    return (
        len(w) >= 2
        and w[-1] not in _VOWELS
        and w[-1] not in "wxy"
        and w[-2] in _VOWELS
        and (len(w) < 3 or w[-3] not in _VOWELS)
    )


def morph_derive(word: str, phons):
    """Regular inflections/derivations of a lexicon entry, both tiers at once —
    standard English morphophonology (voicing assimilation for -s, syllabic
    IH Z / IH D after sibilants/alveolar stops, silent-e and y→i orthography).
    Pronunciation-consistent pseudo-words are fine training signal for a
    spelling→sound model, so no dictionary check on the derived form; anything
    orthographically ambiguous (consonant doubling) is skipped instead."""
    last = phons[-1]
    out = {}

    # -s / -es (plural & 3sg)
    if last in _SIBILANT:
        plural = word + ("es" if not word.endswith("e") else "s")
        out[plural] = phons + ["IH", "Z"]
    else:
        tail = ["S"] if last in _VOICELESS else ["Z"]
        if word.endswith("y") and len(word) > 2 and word[-2] not in _VOWELS:
            out[word[:-1] + "ies"] = phons + ["Z"]
        elif not word.endswith(("s", "x", "z")):
            out[word + "s"] = phons + tail

    # -ing / -ed (drop final silent e; skip doubling-risk stems)
    if word.endswith("e") and not word.endswith("ee"):
        stem = word[:-1]
    elif _cvc_risky(word):
        stem = None
    else:
        stem = word
    if stem:
        if last != "NG":
            out[stem + "ing"] = phons + ["IH", "NG"]
        if last in ("T", "D"):
            out[stem + "ed"] = phons + ["IH", "D"]
        elif word.endswith("y") and len(word) > 2 and word[-2] not in _VOWELS:
            out[word[:-1] + "ied"] = phons + ["D"]
        else:
            out[stem + "ed"] = phons + (["T"] if last in _VOICELESS else ["D"])

    # -ly, -ness (y→i), -er (comparative/agentive)
    if not word.endswith("y"):
        out[word + "ly"] = phons + ["L", "IY"]
        out[word + "ness"] = phons + ["N", "AH", "S"]
    elif last == "IY":
        out[word[:-1] + "iness"] = phons[:-1] + ["IY", "N", "AH", "S"]
    if word.endswith("e"):
        out[word + "r"] = phons + ["ER"]
    elif word.endswith("y") and len(word) > 2 and word[-2] not in _VOWELS:
        out[word[:-1] + "ier"] = phons[:-1] + ["IY", "ER"] if last == "IY" else phons + ["ER"]
    elif not _cvc_risky(word):
        out[word + "er"] = phons + ["ER"]

    # Prefixes with invariant pronunciations (fully regular regardless of
    # lexicality — pronunciation-consistent pseudo-words are fine signal).
    # Junction guards mirror compound_derive: skip seams where concatenation
    # changes letter-to-sound rules — a doubled letter across the boundary
    # ("non"+"name"), or a vowel-initial stem after a vowel-final prefix
    # ("pre"+"end" would train 'ee' → IY-EH against the digraph rule).
    def _pfx(prefix: str, pron: list) -> None:
        if prefix[-1] == word[0]:
            return
        if prefix[-1] in _VOWELS and word[0] in _VOWELS:
            return
        out[prefix + word] = pron + phons

    _pfx("un", ["AH", "N"])
    _pfx("re", ["R", "IY"])
    _pfx("dis", ["D", "IH", "S"])
    _pfx("mis", ["M", "IH", "S"])
    _pfx("non", ["N", "AA", "N"])
    _pfx("pre", ["P", "R", "IY"])
    _pfx("over", ["OW", "V", "ER"])
    _pfx("under", ["AH", "N", "D", "ER"])
    _pfx("out", ["AW", "T"])

    # Derivational suffixes with invariant pronunciations.
    out[word + "ful"] = phons + ["F", "UH", "L"]
    out[word + "less"] = phons + ["L", "AH", "S"]
    out[word + "ment"] = phons + ["M", "AH", "N", "T"]
    if not word.endswith(("s", "sh", "ch", "e")):
        out[word + "ish"] = phons + ["IH", "SH"]
    # -est (superlative): same stem orthography as -er.
    if word.endswith("e") and not word.endswith("ee"):
        out[word + "st"] = phons + ["AH", "S", "T"]
    elif word.endswith("y") and len(word) > 2 and word[-2] not in _VOWELS:
        if last == "IY":
            out[word[:-1] + "iest"] = phons[:-1] + ["IY", "AH", "S", "T"]
    elif not _cvc_risky(word):
        out[word + "est"] = phons + ["AH", "S", "T"]
    # -able (drop final silent e).
    able_stem = word[:-1] if word.endswith("e") and not word.endswith("ee") else word
    if not _cvc_risky(word):
        out[able_stem + "able"] = phons + ["AH", "B", "AH", "L"]

    # More invariant derivational suffixes.
    out[word + "hood"] = phons + ["HH", "UH", "D"]
    out[word + "ship"] = phons + ["SH", "IH", "P"]
    out[word + "like"] = phons + ["L", "AY", "K"]
    out[word + "wise"] = phons + ["W", "AY", "Z"]
    out[word + "dom"] = phons + ["D", "AH", "M"]
    out[word + "ward"] = phons + ["W", "ER", "D"]

    return {w: p for w, p in out.items() if p is not None}


def compound_derive(train: dict, n_pairs: int, seed: int = 0) -> dict:
    """Sampled two-word closed compounds (sun+light → sunlight): concatenated
    spelling and phones. English compound orthography/pronunciation is exactly
    concatenation for the overwhelming majority of noun-noun compounds, so these
    are pronunciation-consistent pseudo-words that teach the model to find
    morpheme boundaries in long unseen spellings."""
    words = sorted(
        w for w, p in train.items()
        if 3 <= len(w) <= 7 and w.isalpha() and 2 <= len(p) <= 6
    )
    rng = np.random.default_rng(seed)
    out = {}
    for _ in range(n_pairs * 3):  # oversample; collisions/filters eat some
        if len(out) >= n_pairs:
            break
        a, b = words[rng.integers(len(words))], words[rng.integers(len(words))]
        if a == b:
            continue
        w = a + b
        # Skip junctions that change letter-to-sound rules at the seam: a silent
        # final e (would read as a long-vowel marker for b's onset) or a doubled
        # letter across the boundary.
        if a.endswith("e") or a[-1] == b[0]:
            continue
        if w not in out:
            out[w] = list(train[a]) + list(train[b])
    return out


def build_dataset(augment: bool = True, stress: bool = True, compounds: int = 0, seed: int = 0):
    gold = dict(VENDORED_LEXICON)
    merged = {**gold, **{w: p for w, p in LEXICON.items() if w not in gold}}
    # Encodability filter FIRST (matches tools/g2p_eval.py's universe): a word the
    # model can't encode must be in neither split, or held-out grading would crash
    # on np.stack and shift the published denominators.
    merged = {
        w: p
        for w, p in merged.items()
        if ng.encode_word(w) is not None and ng.encode_phonemes(p) is not None
    }
    held = {
        w: p
        for w, p in merged.items()
        if w in gold and zlib.crc32(w.encode()) % 10 == 0
    }
    train = {w: p for w, p in merged.items() if w not in held}
    if augment:
        derived = {}
        for w, phons in sorted(train.items()):
            for dw, dp in morph_derive(w, phons).items():
                # Real lexicon entries always win; never leak a held-out spelling.
                if dw not in merged and dw not in derived and dw not in held:
                    derived[dw] = dp
        train.update(derived)
    if compounds:
        for w, p in compound_derive(train, compounds, seed).items():
            if w not in merged and w not in train and w not in held:
                train[w] = p
    if stress:
        # Stress-marked targets (rule-derived — text/stress.py documents the
        # no-gold-data caveat). Morphology above ran on stressless phones (its
        # phoneme-class tables are stressless); marks go on LAST so the derived
        # spellings get stress from their own full form.
        train = {w: assign_stress(w, p) for w, p in train.items()}
        held = {w: assign_stress(w, p) for w, p in held.items()}
        # Re-filter encodability: stress marks lengthen nothing, but the stressed
        # ids must exist in the vocab (they do; belt and braces).
        train = {w: p for w, p in train.items() if ng.encode_phonemes(p) is not None}
    train_x, train_y = [], []
    for w, phons in sorted(train.items()):
        cx, cy = ng.encode_word(w), ng.encode_phonemes(phons)
        if cx is None or cy is None:
            continue
        train_x.append(cx)
        train_y.append(cy)
    return np.stack(train_x), np.stack(train_y), held


def schedule(count: int, lr: float, steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.02 * lr) at update
    `count`: linear from 0 over `warmup = min(200, max(1, steps // 10))` updates,
    then a cosine over the remaining `steps - warmup` to 0.02 * lr."""
    warmup = min(200, max(1, steps // 10))
    if count < warmup:
        return lr * count / warmup
    span = max(steps - warmup, 1)
    t = min(count - warmup, span)
    alpha = 0.02
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / span)) + alpha)


def loss_fn(logits: torch.Tensor, targets: torch.Tensor, label_smooth: float) -> torch.Tensor:
    """Cross entropy against onehot * (1 - s) + s / V over all V classes, summed
    over the non-pad targets and divided by max(their count, 1)."""
    mask = (targets != ng.P_PAD).float()
    v = logits.shape[-1]
    soft = torch.nn.functional.one_hot(targets.long(), v).float() * (1.0 - label_smooth) + label_smooth / v
    ll = -(soft * torch.log_softmax(logits.float(), dim=-1)).sum(-1)
    return (ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_optimizer(params: List[torch.nn.Parameter], lr: float, weight_decay: float, steps: int):
    """(AdamW, its schedule): optax's adamw over ONE group, so the decay applies to
    every leaf; `LambdaLR` evaluates `schedule` at the update count from 0."""
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda count: schedule(count, lr, steps) / lr)


def train(
    model: ng.G2P,
    x: np.ndarray,
    y: np.ndarray,
    steps: int = 4000,
    batch: int = 256,
    lr: float = 3e-4,
    seed: int = 0,
    weight_decay: float = 3e-3,
    label_smooth: float = 0.1,
    avg_tail: float = 0.0,
    log: Optional[Callable[[str], None]] = print,
    on_step: Optional[Callable[[int], None]] = None,
) -> Dict[int, float]:
    """Train `model` in place on (x, y) on its device; returns the loss at steps 0,
    250, ... and the last. With `avg_tail` > 0 the model ends as the mean of the
    snapshots taken every 20 steps over the last `avg_tail` of the run (Polyak).
    `on_step(i)` runs after update i (a profiler's step hook)."""
    dev = next(model.parameters()).device
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    opt, sched = make_optimizer(params, lr, weight_decay, steps)
    xd = torch.as_tensor(x, dtype=torch.long, device=dev)
    yd = torch.as_tensor(y, dtype=torch.long, device=dev)
    rng = np.random.default_rng(seed)
    n = len(x)
    avg_sum, n_avg = None, 0
    avg_from = int(steps * (1.0 - avg_tail))
    losses: Dict[int, float] = {}
    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, size=min(batch, n)), device=dev)
        bx, by = xd[idx], yd[idx]
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(ng.teacher_logits(model, bx, by), by, label_smooth)
        loss.backward()
        opt.step()
        sched.step()
        if avg_tail > 0 and i >= avg_from and (i - avg_from) % 20 == 0:
            with torch.no_grad():
                if avg_sum is None:
                    avg_sum = [p.detach().clone() for p in params]
                else:
                    torch._foreach_add_(avg_sum, [p.detach() for p in params])
            n_avg += 1
        if i % 250 == 0 or i == steps - 1:
            losses[i] = float(loss.detach())
            if log:
                log(f"step {i}: loss {losses[i]:.4f}")
        if on_step:
            on_step(i)
    with torch.no_grad():
        if n_avg:
            for p, s in zip(params, avg_sum):
                p.copy_(s / n_avg)
            if log:
                log(f"tail-averaged {n_avg} snapshots from step {avg_from}")
        for p in params:
            p.requires_grad_(False)
            p.grad = None
    return losses


def decode_words(model: ng.G2P, words: List[str]) -> List[List[str]]:
    """Greedy pronunciations of `words` (all encodable) in one batched decode."""
    dev = next(model.parameters()).device
    chars = torch.as_tensor(np.stack([ng.encode_word(w) for w in words]), dtype=torch.long, device=dev)
    ids = ng.greedy_decode(model, chars).cpu().numpy()
    return [ng.decode_ids(row) for row in ids]


def held_out_report(model: ng.G2P, held: Dict[str, List[str]], stress: bool = True) -> dict:
    """The held-out grading of the JAX tool: the model's greedy pronunciations
    against `held` (stressed references when `stress`), stressless too, the stress
    accuracy given the phonemes, and the LTS rules' stressless baseline."""
    words = sorted(held)
    preds = decode_words(model, words)
    report = {"held_out_neural": grade([(preds[i], held[w]) for i, w in enumerate(words)])}
    if stress:
        report["held_out_neural_stressless"] = grade(
            [(strip_stress(preds[i]), strip_stress(held[w])) for i, w in enumerate(words)]
        )
        base_ok = [i for i, w in enumerate(words) if strip_stress(preds[i]) == strip_stress(held[w])]
        report["stress_acc_given_phonemes"] = round(
            sum(preds[i] == held[words[i]] for i in base_ok) / max(len(base_ok), 1), 4
        )
    lts_refs = {w: strip_stress(held[w]) for w in words} if stress else held
    report["held_out_lts_stressless"] = grade(
        [(_word_to_phonemes_lts(w.replace("'", "")), lts_refs[w]) for w in words]
    )
    return report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weight-decay", type=float, default=3e-3)
    ap.add_argument("--label-smooth", type=float, default=0.1)
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--save-path", default=SAVE_PATH,
                    help="weights npz destination (default: build/g2p/g2p_weights.npz)")
    ap.add_argument("--no-stress", action="store_true",
                    help="train stressless targets (pre-round-3 behavior)")
    ap.add_argument("--compounds", type=int, default=0,
                    help="add N sampled two-word pseudo-compounds to the train set")
    ap.add_argument("--avg-tail", type=float, default=0.0,
                    help="Polyak-average the weights over the last FRACTION of steps")
    ap.add_argument("--d-model", type=int, default=ng.D_MODEL)
    ap.add_argument("--d-ff", type=int, default=ng.D_FF)
    ap.add_argument("--enc-layers", type=int, default=ng.ENC_LAYERS)
    ap.add_argument("--dec-layers", type=int, default=ng.DEC_LAYERS)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Build the data, train, grade, save; returns the held-out report."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    x, y, held = build_dataset(stress=not args.no_stress, compounds=args.compounds, seed=args.seed)
    print(f"train pairs: {len(x)}, held-out: {len(held)}", flush=True)
    model = ng.init(
        torch.Generator().manual_seed(args.seed), d_model=args.d_model, d_ff=args.d_ff,
        enc_layers=args.enc_layers, dec_layers=args.dec_layers, device=dev,
    )
    t0 = time.perf_counter()
    train(
        model, x, y, steps=args.steps, batch=args.batch, lr=args.lr, seed=args.seed,
        weight_decay=args.weight_decay, label_smooth=args.label_smooth, avg_tail=args.avg_tail,
        log=lambda line: print(line, flush=True),
    )
    print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f} s on {dev}", flush=True)
    report = held_out_report(model, held, stress=not args.no_stress)
    print(json.dumps(report), flush=True)
    if not args.no_save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
        ng.save_weights(model, args.save_path)
        print(f"saved {args.save_path} ({os.path.getsize(args.save_path) // 1024} KiB)", flush=True)
    return report


if __name__ == "__main__":
    main()
