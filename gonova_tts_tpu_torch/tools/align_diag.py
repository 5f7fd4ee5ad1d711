"""Aligner-in-isolation diagnostic: can the MAS aligner learn the corpus alignment?

The port's copy of the JAX package's tools/align_diag.py, with its flags and JSON
lines. Trains ONLY models/aligner.py (forward-sum [+ optional bin loss], the
diagonal prior annealed linearly to 0 over --prior-steps) on the corpus batches,
taken round-robin, with optax's `chain([clip_by_global_norm,] adamw(lr,
weight_decay=0.01))` at a constant rate, and grades MAS durations WITHOUT the prior
against the generator's ground-truth per-token durations
(synth_corpus.utterance_durations) at step 0 and every --eval-every steps. Isolates
the aligner from the joint objective, so optimizer coupling (shared rate, global
gradient clipping) can be ruled in or out.

    python -m gonova_tts_tpu_torch.tools.align_diag --corpus DIR [--lr 3e-3] [--steps 2000]
        [--bin-weight 0.0] [--clip 0] [--device cpu | --cpu]

Runs on CUDA unless `--device cpu` (or `--cpu`). Prints one JSON line per eval
point. `run` also returns the aligner's step time on this device (host clock, each
step synchronized, the first step and the profiled one left out) and, on a card,
one warm step's device kernels, busy time and idle share from torch.profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import aligner
from ..models.params import _load_strict
from ..text import text_to_ids
from ..text.symbols import SYMBOLS
from ..train.data import ManifestDataset, load_manifest
from ..train.step import clip_by_global_norm_, global_norm
from ..train.synth_corpus import is_silence_symbol, load_corpus_meta, utterance_durations
from ..utils.prof import device_events

BATCH_KEYS = ("tokens", "token_mask", "mel", "align_mel", "frame_mask")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--bin-weight", type=float, default=0.0)
    ap.add_argument("--prior-sigma", type=float, default=0.12,
                    help="diagonal prior width (normalized coords); 0 disables")
    ap.add_argument("--prior-steps", type=int, default=1000,
                    help="linear anneal: full prior at step 0, off by this step")
    ap.add_argument("--clip", type=float, default=0.0, help="global-norm clip (0 = off)")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def corpus_batches(corpus: str, cfg: ModelConfig):
    """(host batches of the train manifest, ground-truth durations keyed by the
    token ids' int32 bytes): batch 8, the 64-token bucket, alignment features."""
    # Rate-varied corpora scale every token's true duration by the sentence's tempo.
    rate_variation = load_corpus_meta(corpus)["rate_variation"]
    manifest = os.path.join(corpus, "manifest_train.txt")
    if not os.path.exists(manifest):
        manifest = os.path.join(corpus, "manifest.txt")
    ds = ManifestDataset(manifest, cfg, batch_size=8, token_buckets=(64,), learn_alignment=True, ref_mel=False)
    batches = [{k: v for k, v in b.items() if k in BATCH_KEYS} for b in ds.epoch(0)]
    truth = {}
    for e in load_manifest(manifest):
        ids = text_to_ids(e["text"])
        truth[np.asarray(ids, np.int32).tobytes()] = np.asarray(
            utterance_durations(ids, e["text"], rate_variation=rate_variation), np.int64
        )
    return batches, truth


def grade_durations(durs: List[np.ndarray], batches: List[Dict[str, np.ndarray]], truth) -> dict:
    """MAS durations against the true ones, per utterance: mean |error| in frames
    and the correlation, over all tokens and with silence tokens left out (splits
    between ADJACENT silence tokens, such as a stop's tail then "<sp>", are
    acoustically unobservable, so no aligner can recover them)."""
    errs, corrs, ns_errs, ns_corrs, n = [], [], [], [], 0
    for dur, b in zip(durs, batches):
        toks, mask = b["tokens"], b["token_mask"]
        for i in range(dur.shape[0]):
            length = int(mask[i].sum())
            if length == 0:
                continue
            t = truth.get(toks[i, :length].astype(np.int32).tobytes())
            if t is None or len(t) != length:
                continue
            d = dur[i, :length].astype(np.int64)
            errs.append(np.abs(d - t).mean())
            if d.std() > 0 and t.std() > 0:
                corrs.append(float(np.corrcoef(d, t)[0, 1]))
            ns = np.asarray([not is_silence_symbol(SYMBOLS[x]) for x in toks[i, :length]], bool)
            if ns.sum() >= 2:
                ns_errs.append(np.abs(d[ns] - t[ns]).mean())
                if d[ns].std() > 0 and t[ns].std() > 0:
                    ns_corrs.append(float(np.corrcoef(d[ns], t[ns])[0, 1]))
            n += 1
    return {
        "utts": n,
        "dur_mae": round(float(np.mean(errs)), 3) if errs else None,
        "dur_corr": round(float(np.mean(corrs)), 4) if corrs else None,
        "dur_mae_nonsil": round(float(np.mean(ns_errs)), 3) if ns_errs else None,
        "dur_corr_nonsil": round(float(np.mean(ns_corrs)), 4) if ns_corrs else None,
    }


def run(args: argparse.Namespace, params: Optional[Mapping] = None,
        emit: Callable[[str], None] = lambda line: print(line, flush=True)) -> dict:
    """Train and grade; `emit` gets each eval point's JSON line. `params` is an
    initial aligner tree of numpy arrays (JAX's `aligner.init` layout), else
    `aligner.init` from a generator seeded 0. Returns {"lines", "ms_per_step",
    "launches_per_step", "device_busy_ms_per_step", "device_idle_share",
    "steps_timed", "device"}; the device readings are None on the CPU."""
    dev = resolve_device("cpu" if args.cpu else args.device)
    cfg = ModelConfig()
    host_batches, truth = corpus_batches(args.corpus, cfg)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()} for b in host_batches]
    if params is None:
        node = aligner.init(torch.Generator().manual_seed(0), cfg, dim=args.dim).to(dev)
    else:
        node = _load_strict(aligner.init(torch.Generator().manual_seed(0), cfg, dim=args.dim), params, dev)
    node.requires_grad_(True)
    leaves = list(node.parameters())
    # optax.adamw's defaults: eps outside the square root after bias correction and
    # the decay of the old parameter, as torch.optim.AdamW (train/step.py).
    opt = torch.optim.AdamW(leaves, lr=args.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def loss_of(b, prior_w: float) -> torch.Tensor:
        tm, fm = b["token_mask"], b["frame_mask"]
        prior = prior_w * aligner.diagonal_prior(tm, fm, sigma=args.prior_sigma) if args.prior_sigma > 0 else None
        lp = aligner.log_probs(node, b["tokens"], b.get("align_mel", b["mel"]), tm, prior=prior, frame_mask=fm)
        loss = aligner.forward_sum_loss(lp, tm, fm)
        if args.bin_weight > 0:
            dur = aligner.mas_durations(lp.detach(), tm, fm)
            loss = loss + args.bin_weight * aligner.bin_loss(lp, dur, fm)
        return loss

    def step(b, prior_w: float) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_of(b, prior_w)
        loss.backward()  # every leaf enters the scores, so every leaf gets a gradient
        grads = [p.grad for p in leaves]
        if args.clip > 0:
            clip_by_global_norm_(grads, global_norm(grads), args.clip)
        opt.step()
        return loss.detach()

    def grade() -> dict:
        durs = []
        with torch.no_grad():
            for b in batches:
                # Graded WITHOUT the prior: what the learned scores alone align.
                lp = aligner.log_probs(node, b["tokens"], b.get("align_mel", b["mel"]), b["token_mask"],
                                       frame_mask=b["frame_mask"])
                durs.append(aligner.mas_durations(lp, b["token_mask"], b["frame_mask"]).cpu().numpy())
        return grade_durations(durs, host_batches, truth)

    profiled = args.steps - 1 if dev.type == "cuda" and args.steps >= 2 else None
    lines, step_s, trace = [], [], None
    loss = None
    for i in range(args.steps + 1):
        if i % args.eval_every == 0:
            line = {"step": i, "loss": None if loss is None else round(float(loss), 4), **grade()}
            lines.append(line)
            emit(json.dumps(line))
        if i < args.steps:
            w = max(0.0, 1.0 - i / max(args.prior_steps, 1))
            b = batches[i % len(batches)]
            if i == profiled:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
                    loss = step(b, w)
                    sync()
                continue
            sync()
            t0 = time.perf_counter()
            loss = step(b, w)
            sync()
            if i > 0:  # the first step pays the first-call costs
                step_s.append(time.perf_counter() - t0)

    ms = float(np.mean(step_s)) * 1e3 if step_s else None
    out = {"lines": lines, "ms_per_step": ms, "steps_timed": len(step_s),
           "launches_per_step": None, "device_busy_ms_per_step": None, "device_idle_share": None,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    events = device_events(trace) if trace is not None else []
    if events:
        busy = sum(e.self_device_time_total for e in events) / 1e3
        out.update({
            "launches_per_step": sum(e.count for e in events), "device_busy_ms_per_step": busy,
            "device_idle_share": max(0.0, 1 - busy / ms) if ms else None,
        })
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
