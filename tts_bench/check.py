"""Whether what the window served is correct, by the plain reference.

After the window: a sample of the sentences the window served, drawn from the seed
(`sample` of them, uniformly over every sentence of the window's finished requests,
at least `sample_cloned` from requests that cloned a voice where the mix clones
them), and the longest served sentence. For each, the reference works out the text's
sentences, the ids, the speaker embedding from the recording, the mel and the PCM16
audio in float32 (TF32 off), and compare.py measures the served audio against it.

Numbers compared, each against the cell's limit:
  * `failed`: requests of the window that failed (limit 0);
  * `unjudged`: 1 where no request finished, so nothing could be compared (limit 0);
  * `segments`: sampled requests whose sentences the reference splits otherwise
    than the service did (limit 0);
  * `mel_db`: the mean mel gap in dB over every reference frame of the sample;
  * `frames_pct`: the differences in length summed over the sample, in percent of
    the reference's frames.
The widest single sentence (its mean gap, its length difference) is reported
beside them, not compared: in bfloat16 it swings from seed to seed to within 2.5x
of the float8 control's (PERF.md).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import compare
from .loadgen import rng_for
from .reference import audio as ref_audio
from .reference.model import Numerics, Reference, load_tree
from .reference.text import pick_bucket, segment_text, text_to_ids


def voice_of(voices, default_wav: bytes):
    """result → (a key for the embedding, the recording the request spoke with)."""

    def of(res):
        if res.request.voice is None:
            return "default", default_wav
        return f"v{res.request.voice}", voices[res.request.voice].wav

    return of


def sample(results, mix: dict, seed: int) -> List[Tuple[object, int]]:
    """(result, sentence index) pairs to compare."""
    pool = [(r, i) for r in results if not r.failed for i in range(len(r.parts))]
    if not pool:
        return []
    rng = rng_for(seed, 9)
    k = min(mix["sample"], len(pool))
    picked = [pool[j] for j in rng.choice(len(pool), size=k, replace=False)]

    def cloned(p):
        return p[0].voice_id.startswith("clone")

    want = min(mix.get("sample_cloned", 0), sum(map(cloned, pool)), k)
    have = sum(map(cloned, picked))
    if have < want:
        taken = {(id(r), i) for r, i in picked}
        extra = [pool[j] for j in rng.permutation(len(pool)) if cloned(pool[j]) and (id(pool[j][0]), pool[j][1]) not in taken]
        picked = [p for p in picked if cloned(p)] + extra[: want - have] + [p for p in picked if not cloned(p)][: k - want]
    longest = max(pool, key=lambda p: len(p[0].parts[p[1]]))
    if all(longest[0] is not r or longest[1] != i for r, i in picked):
        picked.append(longest)
    return picked


class Judge:
    """The reference of one configuration, and the speakers it embeds itself."""

    def __init__(self, model: dict, engine: dict, checkpoint: str, device, numerics: str = "fp32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.s = dict(model)
        self.buckets = engine["token_buckets"]
        tree, meta = load_tree(checkpoint, device)
        self.stress = meta.get("stress")
        self.ref = Reference(tree, self.s, device, Numerics(numerics))
        self.device = device
        self._speakers: Dict[str, np.ndarray] = {}

    def speaker(self, key: str, wav_bytes: bytes) -> np.ndarray:
        if key not in self._speakers:
            x, sr = ref_audio.read_wav(wav_bytes)
            with torch.no_grad():
                self._speakers[key] = self.ref.embed(x, sr)
        return self._speakers[key]

    def sentences(self, text: str) -> List[str]:
        return segment_text(text)

    def speak(self, sentence: str, speaker: np.ndarray, exaggeration: float) -> np.ndarray:
        ids = text_to_ids(sentence, with_stress=self.stress)
        bucket = pick_bucket(len(ids), self.buckets)
        return self.ref.speak(ids[:bucket], bucket, speaker, exaggeration)


def judge(measured, picked, judge_: Judge, voice_of, exaggeration: float, limits: dict,
          served_of=None) -> Tuple[Dict[str, dict], dict]:
    """(the compared numbers with their limits, other readings) of the window's
    requests `measured` and the sentences `picked` of them. `voice_of(result)`
    gives (key, WAV bytes) of its speaker; `served_of(result, i)` the served audio
    of a sentence (default: what the window kept)."""
    t0 = time.perf_counter()
    failed = sum(r.failed for r in measured)
    segments, sum_db, ref_frames, frame_gap, gap_db, worst = 0, 0.0, 0, 0.0, 0.0, {}
    split: Dict[int, List[str]] = {}
    for res, i in picked:
        if id(res) not in split:
            split[id(res)] = judge_.sentences(res.request.text)
            if len(split[id(res)]) != len(res.parts):
                segments += 1
        sents = split[id(res)]
        if len(sents) != len(res.parts):
            continue
        key, wav = voice_of(res)
        ref = judge_.speak(sents[i], judge_.speaker(key, wav), exaggeration)
        served = res.parts[i].astype(np.float32) / 32768.0 if served_of is None else served_of(res, i)
        g = compare.sentence_gap(served, ref, judge_.s, judge_.device)
        mean = g["sum_db"] / g["ref_frames"]
        if not worst or mean >= worst["mean_db"]:
            worst = {"mean_db": mean, "frames": g["frames"], "gap_db": g["gap_db"], "voice": res.voice_id,
                     "sentence": sents[i][:80], "ref_frames": g["ref_frames"]}
        sum_db, ref_frames = sum_db + g["sum_db"], ref_frames + g["ref_frames"]
        frame_gap, gap_db = frame_gap + g["frames"], max(gap_db, g["gap_db"])
    numbers = {
        "failed": {"value": failed, "limit": 0},
        "unjudged": {"value": int(not picked), "limit": 0},
        "segments": {"value": segments, "limit": 0},
        "mel_db": {"value": sum_db / max(ref_frames, 1), "limit": limits["mel_db"]},
        "frames_pct": {"value": 100.0 * frame_gap / max(ref_frames, 1), "limit": limits["frames_pct"]},
    }
    return numbers, {"compared": len(picked), "gap_db": gap_db, "worst": worst, "reference_s": time.perf_counter() - t0}


def correct(numbers: Dict[str, dict]) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())


def lines(numbers: Dict[str, dict]) -> List[str]:
    return [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in numbers.items()]

