"""The traffic generator repeats for a seed, sends every seed the same sizes, and
keeps to the stated distributions; its voices pass the service's gate."""

from __future__ import annotations

import collections
import json
import os
import statistics

import numpy as np
import pytest

from tts_bench import loadgen, spec, voices

CLOSED, OPEN = spec.module("loops", "closed"), spec.module("loops", "open")

NARRATE = json.load(open(os.path.join(spec.HERE, "traffic", "narrate.json")))
LIVE = dict(json.load(open(os.path.join(spec.HERE, "traffic", "live.json"))), rate=9.0)
BIG = 2**40 + 12345


def _docs(mix, seed, n):
    it = CLOSED.requests(loadgen.Generator(mix, seed), mix)
    return [next(it) for _ in range(n)]


def test_documents_repeat_for_a_seed_and_differ_between_seeds():
    a, b, c = _docs(NARRATE, BIG, 5), _docs(NARRATE, BIG, 5), _docs(NARRATE, BIG + 1, 5)
    assert [(d.text, d.voice) for d in a] == [(d.text, d.voice) for d in b]
    assert [d.text for d in a] != [d.text for d in c]


def test_schedule_repeats_and_keeps_its_sizes_across_seeds():
    s1 = OPEN.schedule(loadgen.Generator(LIVE, BIG), LIVE, 35.0)
    s2 = OPEN.schedule(loadgen.Generator(LIVE, BIG), LIVE, 35.0)
    s3 = OPEN.schedule(loadgen.Generator(LIVE, 7), LIVE, 35.0)
    assert [(r.text, r.voice, r.at) for r in s1] == [(r.text, r.voice, r.at) for r in s2]
    assert [r.text for r in s1] != [r.text for r in s3]
    # every seed: the same arrivals, sizes and cloning requests, in the same order
    assert [(r.at, r.voice, len(r.text.split())) for r in s1] == [(r.at, r.voice, len(r.text.split())) for r in s3]


@pytest.mark.parametrize("dist,median,lo,hi", [
    ({"dist": "lognormal", "median": 14, "sigma": 0.5, "min": 5, "max": 40}, 14, 5, 40),
    ({"dist": "uniform", "min": 20, "max": 60}, 40, 20, 60),
    ({"dist": "uniform", "min": 1, "max": 3}, 2, 1, 3),
])
def test_quantile_pools(dist, median, lo, hi):
    q = loadgen.quantiles(dist, 1024)
    assert q.min() >= lo and q.max() <= hi and statistics.median(q) == median
    if dist["dist"] == "uniform":
        counts = collections.Counter(q.tolist())
        assert set(counts) == set(range(lo, hi + 1)) and max(counts.values()) - min(counts.values()) <= 1


def test_live_mix_rates_and_shares():
    sched = OPEN.schedule(loadgen.Generator(LIVE, BIG), LIVE, 40.0)
    assert abs(len(sched) / 40.0 - LIVE["rate"]) < 0.5
    assert abs(sum(r.voice is not None for r in sched) / len(sched) - LIVE["clone_share"]) < 0.02
    lex = set(loadgen.lexicon_words())
    assert all(w.strip(",.?!").lower() in lex for r in sched for w in r.text.split())


def test_narrate_sentence_lengths():
    gen = loadgen.Generator(NARRATE, BIG)
    lengths = [len(gen.sentence().split()) for _ in range(1024)]
    assert min(lengths) >= 5 and max(lengths) <= 40 and statistics.median(lengths) == 14


@pytest.mark.parametrize("loop,mix", [(CLOSED, NARRATE), (OPEN, LIVE)], ids=["closed", "open"])
def test_names_are_out_of_the_lexicon(loop, mix):
    """With `oov_share`, each document or request brings names new to the run, at
    that share of its words."""
    mix = dict(mix, oov_share=0.03, oov_cast=3)
    lex = set(loadgen.lexicon_words())
    reqs = loop.requests(loadgen.Generator(mix, BIG), mix, 40.0)
    seen, words, named = set(), 0, 0
    for _, r in zip(range(40), reqs):
        text = [w.strip(",.?!").lower() for w in r.text.split()]
        new = set(text) - lex
        assert len(new) <= 3 and not new & seen
        seen |= new
        words, named = words + len(text), named + sum(w not in lex for w in text)
    assert 0.015 < named / words < 0.05


@pytest.mark.parametrize("sr", [24000, 44100])
def test_voices_pass_the_gate(sr):
    from gonova_tts_tpu_torch.service.voice_manager import validate_reference_audio
    from tts_bench.reference import audio

    for i in range(4):
        x, rate = audio.read_wav(voices.Voice(BIG, i, sr).wav)
        assert rate == sr and len(x) == 10 * sr
        assert validate_reference_audio(x, rate)["valid"]
