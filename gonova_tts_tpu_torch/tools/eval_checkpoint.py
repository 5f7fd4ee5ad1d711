"""Grade a trained checkpoint end to end through the port's engine.

The port's copy of the JAX package's tools/eval_checkpoint.py, with its flags and
JSON keys. Through the real engine (the serving compute path, not a test harness):
  1. held-in mel reconstruction: synthesize corpus sentences with each speaker's
     reference embedding and compare the output's mel with the corpus ground
     truth (mel L1 / MSE / MCD over the overlapping frames), decomposed into the
     acoustic stage's predicted mel and the vocoder's floor (the ground-truth mel
     vocoded and measured again); with a variable-duration corpus, per-token
     durations against the generator's ground truth;
  2. streaming exactness on the trained weights: the streamed chunks concatenated
     against the batch path, in int16 LSBs;
  3. voice-clone margin: same-voice vs cross-voice speaker-encoder cosine
     similarity of synthesized outputs (clone_eval's metric, inline);
  4. optionally never-seen voices (`--unseen-speakers N`): one-shot cloning graded
     the same way.

    python -m gonova_tts_tpu_torch.tools.eval_checkpoint --checkpoint CKPT --corpus DIR [--device cpu]

`--checkpoint` is an npz or a training root (its newest step). Runs on CUDA unless
`--device cpu`. Prints one JSON object; exits nonzero if the clone margin is not
positive.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..audio.mel import mcd, mel_spectrogram
from ..config import Config, ModelConfig
from ..engine import TTSEngine
from ..models import tts as tmodel
from ..text import pick_bucket, text_to_ids
from ..text.symbols import SYMBOLS
from ..train.synth_corpus import (
    generate_corpus, is_silence_symbol, load_corpus_meta, make_unseen_speakers, utterance_durations,
)
from ..utils import read_wav

# ---------------------------------------------------------------- metric helpers


def mel_of(wav: np.ndarray, mcfg: ModelConfig, device) -> np.ndarray:
    """[T] audio → [frames, n_mels] natural-log mel (the plain f32 mel, on `device`)."""
    with torch.inference_mode():
        m = mel_spectrogram(
            torch.as_tensor(np.asarray(wav, np.float32), device=device)[None], sr=mcfg.sample_rate,
            n_fft=mcfg.n_fft, hop_length=mcfg.hop_length, win_length=mcfg.win_length,
            n_mels=mcfg.n_mels, fmin=mcfg.fmin, fmax=mcfg.fmax,
        )[0]
    return m.cpu().numpy()


def mel_distances(m_out: np.ndarray, m_gt: np.ndarray) -> Dict[str, float]:
    """Over the overlapping frames: mel L1 and MSE, the cepstral MCD (DCT-II, c0
    dropped, 13 coefficients: audio/mel.mcd) and the older dB-scaled L2 over all
    bins with the energy term (`logmel_dist_db`, kept for older tables)."""
    t = min(len(m_gt), len(m_out))
    d = m_out[:t] - m_gt[:t]
    return {
        "mel_l1": float(np.abs(d).mean()),
        "mel_mse": float((d**2).mean()),
        "mcd_db": float(mcd(torch.as_tensor(m_out[:t]), torch.as_tensor(m_gt[:t]))),
        "logmel_dist_db": float((10.0 / np.log(10.0)) * np.sqrt(2.0 * (d**2).sum(-1)).mean()),
    }


def mel_l1(a: np.ndarray, b: np.ndarray) -> float:
    t = min(len(a), len(b))
    return float(np.abs(a[:t] - b[:t]).mean())


def len_ratio(n_out: int, n_gt: int) -> float:
    """Output frames over ground-truth frames: the durations' overall rate."""
    return float(n_out / max(n_gt, 1))


def clone_margin(same: Sequence[float], cross: Sequence[float]) -> float:
    """Mean same-voice minus mean cross-voice cosine similarity."""
    return float(np.mean(same) - np.mean(cross))


def clone_similarities(engine: TTSEngine, text: str, refs: Dict[str, np.ndarray], voices: Sequence[str],
                       pool: Optional[Dict[str, np.ndarray]] = None, train: Sequence[str] = ()):
    """(same, cross, cross_train): the cosine similarity of each voice's
    synthesized `text`, embedded again, with every reference embedding in `pool`
    (default `refs`; embeddings are unit-norm, so a dot product); `cross_train` is
    the part of `cross` against the references named in `train` (the training
    speakers')."""
    pool = refs if pool is None else pool
    same, cross, cross_train = [], [], []
    for name in voices:
        out = engine.synthesize_batch([text], speakers=[refs[name]])[0]
        emb = engine.embed_voice(out, engine.sample_rate)
        for other, ref in pool.items():
            sim = float(np.dot(emb, ref))
            if other == name:
                same.append(sim)
            else:
                cross.append(sim)
                if other in train:
                    cross_train.append(sim)
    return same, cross, cross_train


# ---------------------------------------------------------------- the grader


def _mean(rows: List[dict], key: str) -> Optional[float]:
    vals = [r[key] for r in rows if key in r]
    return float(np.mean(vals)) if vals else None


class Grader:
    """Held-in / held-out reconstruction and duration grading of one engine."""

    def __init__(self, engine: TTSEngine, sentences: Sequence[str], variable: bool, rate_variation: bool):
        self.engine, self.mcfg = engine, engine.mcfg
        self.sentences, self.variable, self.rate_variation = list(sentences), variable, rate_variation

    def mel(self, wav: np.ndarray) -> np.ndarray:
        return mel_of(wav, self.mcfg, self.engine.device)

    def _bucketed(self, ids):
        # The engine's bucketing; a sentence above the largest bucket is cut to it.
        bucket = pick_bucket(len(ids), self.engine.ecfg.token_buckets)
        ids = list(ids)[:bucket]
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, : len(ids)] = ids
        mask = (np.arange(bucket)[None] < len(ids)).astype(np.float32)
        return tokens, mask, len(ids)

    def _acoustic(self, text: str, emb: np.ndarray):
        tokens, mask, n = self._bucketed(text_to_ids(text))
        eng = self.engine
        with torch.inference_mode():
            out = tmodel.acoustic_mel(
                eng.params, torch.as_tensor(tokens, device=eng.device), torch.as_tensor(mask, device=eng.device),
                torch.as_tensor(np.asarray(emb, np.float32), device=eng.device)[None],
                torch.full((1,), 0.5, device=eng.device), self.mcfg, dtype=eng.compute_dtype,
            )
        t = int(out["total_frames"][0])
        return out["mel"][0, :t].float().cpu().numpy(), out["durations"][0, :n].cpu().numpy().astype(np.int32)

    def vocoder_floor(self, gt_wav: np.ndarray) -> float:
        m_gt = self.mel(gt_wav)
        eng = self.engine
        with torch.inference_mode():
            wav = tmodel.vocode(
                eng.params, torch.as_tensor(m_gt, device=eng.device).to(eng.compute_dtype)[None], self.mcfg,
                dtype=eng.compute_dtype,
            )
        return mel_l1(self.mel(wav[0].float().cpu().numpy()), m_gt)

    def durations(self, text: str, emb: np.ndarray) -> Dict[str, float]:
        """Per-token durations against `utterance_durations`, all tokens and with the
        silence tokens left out (their splits are acoustically unobservable)."""
        ids = text_to_ids(text)
        true_d = np.asarray(utterance_durations(ids, text, rate_variation=self.rate_variation), np.float64)
        pred_d = self._acoustic(text, emb)[1].astype(np.float64)
        n = min(len(true_d), len(pred_d))  # a sentence cut to the largest bucket: its prefix
        true_d, pred_d, ids = true_d[:n], pred_d[:n], list(ids)[:n]
        row = {"dur_mae_frames": float(np.abs(pred_d - true_d).mean())}
        if true_d.std() > 0 and pred_d.std() > 0:
            row["dur_corr"] = float(np.corrcoef(pred_d, true_d)[0, 1])
        ns = np.asarray([not is_silence_symbol(SYMBOLS[x]) for x in ids], bool)
        if ns.sum() >= 2:
            row["dur_mae_nonsil"] = float(np.abs(pred_d[ns] - true_d[ns]).mean())
            if true_d[ns].std() > 0 and pred_d[ns].std() > 0:
                row["dur_corr_nonsil"] = float(np.corrcoef(pred_d[ns], true_d[ns])[0, 1])
        return row

    def grade(self, sentence_indices, corpus_dir: str, speakers, embs: Dict[str, np.ndarray]) -> dict:
        rows = []
        for spk in speakers:
            for i in sentence_indices:
                text = self.sentences[i]
                gt, _ = read_wav(os.path.join(corpus_dir, f"{spk.name}_{i:02d}.wav"))
                gt = np.asarray(gt, np.float32)
                out = self.engine.synthesize_batch([text], speakers=[embs[spk.name]])[0]
                m_gt, m_out = self.mel(gt), self.mel(out)
                row = mel_distances(m_out, m_gt)
                row["acoustic_mel_l1"] = mel_l1(self._acoustic(text, embs[spk.name])[0], m_gt)
                row["voc_floor_mel_l1"] = self.vocoder_floor(gt)
                row["len_ratio"] = len_ratio(len(m_out), len(m_gt))
                if self.variable:
                    row.update(self.durations(text, embs[spk.name]))
                rows.append(row)
        keys = ["mel_l1", "mel_mse", "mcd_db", "acoustic_mel_l1", "voc_floor_mel_l1", "len_ratio"]
        if self.variable:
            keys += ["dur_mae_frames", "dur_corr", "dur_mae_nonsil", "dur_corr_nonsil"]
        return {k: v for k in keys if (v := _mean(rows, k)) is not None}


def duration_keys(split: str, grades: dict) -> dict:
    if "dur_mae_frames" not in grades:
        return {}
    out = {
        f"{split}_dur_mae_frames": round(grades["dur_mae_frames"], 3),
        f"{split}_dur_corr": round(grades.get("dur_corr", 0.0), 4),
    }
    if "dur_mae_nonsil" in grades:
        out[f"{split}_dur_mae_nonsil"] = round(grades["dur_mae_nonsil"], 3)
        out[f"{split}_dur_corr_nonsil"] = round(grades.get("dur_corr_nonsil", 0.0), 4)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--corpus", required=True, help="synth_corpus output dir")
    ap.add_argument("--sentences", type=int, default=3, help="held-in sentences to grade")
    ap.add_argument("--heldout", type=int, default=-1,
                    help="also grade the LAST N sentences (the generalization split "
                         "written by synth_corpus --holdout); -1 = read the corpus "
                         "meta, 0 = disable")
    ap.add_argument("--variable", action="store_true",
                    help="corpus was generated with --variable: grade per-token "
                         "durations against utterance_durations ground truth "
                         "(auto-detected from corpus_meta.json when present)")
    ap.add_argument("--max-speakers", type=int, default=8,
                    help="cap graded speakers on large corpora (0 = all); the cap "
                         "takes an even spread so generated voices are represented")
    ap.add_argument("--unseen-speakers", type=int, default=0,
                    help="additionally grade N NEVER-SEEN voices (one-shot cloning): "
                         "generates an eval-only corpus of make_unseen_speakers(N) "
                         "voices next to --corpus, embeds each reference through the "
                         "serving path, and reports clone margin / mel L1 / durations "
                         "for speakers the model never trained on")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--f32", action="store_true", help="serve in float32 (default bf16)")
    return ap.parse_args(argv)


def evaluate(args: argparse.Namespace, cfg: Optional[Config] = None) -> dict:
    """The grades of `args.checkpoint` as one JSON-ready dict. `cfg` replaces
    `Config()` (its model path, warm-up shapes, device and dtype are set from
    `args`)."""
    meta = load_corpus_meta(args.corpus)
    sentences, all_speakers = meta["sentences"], meta["speakers"]
    rate_variation = meta["rate_variation"]
    variable = args.variable or meta["variable"]
    n_heldout = meta["holdout"] if args.heldout < 0 else args.heldout
    if args.max_speakers > 0 and len(all_speakers) > args.max_speakers:
        idx = np.linspace(0, len(all_speakers) - 1, args.max_speakers).astype(int)
        speakers = [all_speakers[i] for i in sorted(set(idx.tolist()))]
    else:
        speakers = list(all_speakers)

    cfg = (cfg or Config()).model_copy(deep=True)
    cfg.model.model_path = args.checkpoint
    cfg.engine.warmup_shapes = []
    if args.f32:
        cfg.model.compute_dtype = "float32"
    if args.device:
        cfg.model.device = args.device
    engine = TTSEngine(cfg)
    engine.load(warmup=False)
    # The engine's model config: load() infers checkpoint-determined knobs (the
    # Vocos head from its width) on its own copy.
    mcfg = engine.mcfg
    grader = Grader(engine, sentences, variable, rate_variation)

    def embed_refs(corpus_dir, spks):
        out = {}
        for spk in spks:
            audio, sr = read_wav(os.path.join(corpus_dir, f"ref_{spk.name}.wav"))
            out[spk.name] = engine.embed_voice(np.asarray(audio, np.float32), sr)
        return out

    ref_embs = embed_refs(args.corpus, speakers)
    n = len(sentences)
    held_in = grader.grade(range(args.sentences), args.corpus, speakers, ref_embs)
    held_out = grader.grade(range(n - n_heldout, n), args.corpus, speakers, ref_embs) if n_heldout > 0 else None

    # Streaming exactness on the trained weights.
    emb0, text0 = ref_embs[speakers[0].name], sentences[0]
    batch_out = engine.synthesize_batch([text0], speakers=[emb0])[0]
    stream_out = np.concatenate(list(engine.synthesize_stream(text0, speaker=emb0)))
    t = min(len(batch_out), len(stream_out))
    stream_exact_lsb = float(np.max(np.abs(batch_out[:t] - stream_out[:t])) * 32767.0)
    stream_len_match = abs(len(batch_out) - len(stream_out)) <= mcfg.hop_length

    same, cross, _ = clone_similarities(engine, sentences[1], ref_embs, [s.name for s in speakers])
    margin = clone_margin(same, cross)

    unseen = None
    if args.unseen_speakers > 0:
        uns_spk = make_unseen_speakers(args.unseen_speakers)
        uns_dir = args.corpus.rstrip("/") + f"_unseen{args.unseen_speakers}"
        if not os.path.exists(os.path.join(uns_dir, "corpus_meta.json")):
            generate_corpus(
                uns_dir, sentences=list(sentences), speakers=uns_spk, variable=variable, holdout=n_heldout,
                rate_variation=rate_variation,
            )
        uns_embs = embed_refs(uns_dir, uns_spk)
        uns_in = grader.grade(range(args.sentences), uns_dir, uns_spk, uns_embs)
        uns_out = grader.grade(range(n - n_heldout, n), uns_dir, uns_spk, uns_embs) if n_heldout > 0 else None
        # Cross pool: the OTHER unseen references and ALL training references. A
        # model that collapses a new voice onto its nearest training voice scores
        # high on the training speakers but fails here.
        u_same, u_cross, u_cross_train = clone_similarities(
            engine, sentences[1], uns_embs, [s.name for s in uns_spk], pool={**ref_embs, **uns_embs}, train=ref_embs
        )
        unseen = {
            "n_speakers": len(uns_spk),
            "held_in_mel_l1": round(uns_in["mel_l1"], 4),
            "held_in_acoustic_mel_l1": round(uns_in["acoustic_mel_l1"], 4),
            "len_ratio": round(uns_in["len_ratio"], 4),
            "clone_same_voice_mean": round(float(np.mean(u_same)), 4),
            "clone_cross_voice_mean": round(float(np.mean(u_cross)), 4),
            "clone_cross_train_mean": round(float(np.mean(u_cross_train)), 4),
            "clone_margin": round(clone_margin(u_same, u_cross), 4),
        }
        if variable and "dur_corr_nonsil" in uns_in:
            unseen["held_in_dur_corr_nonsil"] = round(uns_in["dur_corr_nonsil"], 4)
        if uns_out is not None:
            unseen["held_out_mel_l1"] = round(uns_out["mel_l1"], 4)
            if variable and "dur_corr_nonsil" in uns_out:
                unseen["held_out_dur_corr_nonsil"] = round(uns_out["dur_corr_nonsil"], 4)

    result = {
        "checkpoint": args.checkpoint,
        "backend": engine.device.type,
        "held_in_mel_l1": round(held_in["mel_l1"], 4),
        "held_in_mel_mse": round(held_in["mel_mse"], 4),
        "held_in_mcd_db": round(held_in["mcd_db"], 3),
        "held_in_acoustic_mel_l1": round(held_in["acoustic_mel_l1"], 4),
        "vocoder_floor_mel_l1": round(held_in["voc_floor_mel_l1"], 4),
        "duration_len_ratio": round(held_in["len_ratio"], 4),
        "stream_vs_batch_max_lsb": round(stream_exact_lsb, 3),
        "stream_len_match": bool(stream_len_match),
        "clone_same_voice_mean": round(float(np.mean(same)), 4),
        "clone_cross_voice_mean": round(float(np.mean(cross)), 4),
        "clone_margin": round(margin, 4),
    }
    if variable:
        result.update(duration_keys("held_in", held_in))
    if held_out is not None:
        result["held_out_mel_l1"] = round(held_out["mel_l1"], 4)
        result["held_out_mcd_db"] = round(held_out["mcd_db"], 3)
        result["held_out_acoustic_mel_l1"] = round(held_out["acoustic_mel_l1"], 4)
        result["held_out_len_ratio"] = round(held_out["len_ratio"], 4)
        result["generalization_gap_mel_l1"] = round(held_out["mel_l1"] - held_in["mel_l1"], 4)
        if variable:
            result.update(duration_keys("held_out", held_out))
    if unseen is not None:
        result["unseen_speakers"] = unseen
    return result


def main(argv=None, cfg: Optional[Config] = None) -> int:
    """Print the grades as one JSON line; 0 when the clone margin is positive."""
    result = evaluate(parse_args(argv), cfg)
    print(json.dumps(result), flush=True)
    return 0 if result["clone_margin"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
