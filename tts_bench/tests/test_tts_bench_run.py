"""Runs of a cell at a tiny config on the CPU, without the harness's look for a
card: the result line's keys, and `correct` coming out false when the served path
is broken underneath (half of a batch answered with another row's audio; the
answers scaled by a quarter where the engine produces them), and for the float8
control."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from tts_bench import control, run, spec
from tts_bench.tests import _tiny

SEED = 2**33 + 17
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
FAMILY = {"hifigan-narrate": "hifigan"}  # the vocoder family a cell's configuration serves


def _run(cell, trace=0, seconds=2.5):
    torch.set_num_threads(4)
    args = run.parse(["--workload", cell.name, "--seed", str(SEED), "--seconds", str(seconds), "--trace", str(trace)])
    code, info, result = run.execute(args, "cpu", cell=cell)
    assert code == 0
    return info, result


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", ["hifigan-narrate", "vocos-live"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tmp, name, trace):
    cell = _tiny.cell(name, tmp, family=FAMILY.get(name, "vocos"))
    info, result = _run(cell, trace)
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["check"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    for m in wanted:
        if m["source"] != "device_trace":  # no device on the CPU: those readers find nothing
            assert m["name"] in result["metrics"], m["name"]
            assert result["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert info["sent"] == result["attempted"]


BURST = '''"""On/off arrivals: the open loop at `burst` times its rate for the first `on_s` of
every `period_s` seconds, and silent for the rest."""

from tts_bench import spec

OPEN = spec.module("loops", "open")
voice_rates, voice_id, requests, warm, trace_at = OPEN.voice_rates, OPEN.voice_id, OPEN.requests, OPEN.warm, OPEN.trace_at


async def run(svc, gen, mix, voices, t0, seconds):
    sched = OPEN.schedule

    def bursts(gen, mix, seconds):
        out = sched(gen, dict(mix, rate=mix["rate"] * mix["burst"]), seconds)
        for r in out:
            k, at = divmod(r.at, mix["on_s"])
            r.at = k * mix["period_s"] + at
        return [r for r in out if r.at < seconds]

    OPEN.schedule = bursts
    try:
        return await OPEN.run(svc, gen, mix, voices, t0, seconds)
    finally:
        OPEN.schedule = sched
'''


def test_a_loop_dropped_in_runs(tmp, tmp_path):
    """A new kind of traffic is a loop module, a mix and a cell, each a new file: the
    harness finds them in a copy of the folder and runs the cell with no edit."""
    here = tmp_path / "tts_bench"
    for kind in ("workloads", "configs", "traffic", "loops", "families", "weights", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, kind), here / kind)
    (here / "loops" / "burst.py").write_text(BURST)
    mix = dict(json.load(open(here / "traffic" / "live.json")), loop="burst", burst=4.0, on_s=0.5, period_s=1.0)
    (here / "traffic" / "live-burst.json").write_text(json.dumps(mix))
    entry = {"config": "nova-vocos-demo", "traffic": "live-burst", "chips": 1, "why": "bursts",
             "params": {}, "limits": {"mel_db": 0.5, "frames_pct": 1.0}}
    (here / "workloads" / "vocos-live-burst.json").write_text(json.dumps(entry))
    bench = spec.benchmark()
    bench = dict(bench, workloads=bench["workloads"] + [{"name": "vocos-live-burst", **{k: entry[k] for k in ("config", "traffic", "chips", "why")}}])
    bench["end_to_end"] = [dict(m, workloads=m.get("workloads", []) + ["vocos-live-burst"]) if m["name"].startswith("ttfa") else m
                           for m in bench["end_to_end"]]
    cell = _tiny.cell("vocos-live-burst", tmp, here=str(here), bench=bench)
    assert spec.loop(cell).__file__ == str(here / "loops" / "burst.py")
    info, result = _run(cell)
    assert result["correct"] is True and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "ttfa_p50_ms", "ttfa_p95_ms"}


QUIET = '''"""A family whose reference is nova's at a quarter of its loudness."""

from tts_bench import spec

NOVA = spec.module("families", "nova")
VOCODER_FORWARDS, pass_ops, vocoder_ops, vocoder_bytes = NOVA.VOCODER_FORWARDS, NOVA.pass_ops, NOVA.vocoder_ops, NOVA.vocoder_bytes


def judge(*args, **kw):
    j = NOVA.judge(*args, **kw)
    speak = j.speak
    j.speak = lambda *a: 0.25 * speak(*a)
    return j
'''


def test_a_family_dropped_in_runs(tmp, tmp_path):
    """A configuration that names a family added as a file is judged by that family's
    reference: one a quarter as loud as the served model makes the run not correct."""
    here = tmp_path / "tts_bench"
    for kind in ("workloads", "configs", "traffic", "loops", "families", "weights", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, kind), here / kind)
    (here / "families" / "quiet.py").write_text(QUIET)
    config = dict(json.load(open(here / "configs" / "nova-vocos-demo.json")), name="quiet-demo", family="quiet")
    (here / "configs" / "quiet-demo.json").write_text(json.dumps(config))
    entry = {"config": "quiet-demo", "traffic": "live", "chips": 1, "why": "a quiet reference",
             "params": {}, "limits": {"mel_db": 0.5, "frames_pct": 1.0}}
    (here / "workloads" / "quiet-live.json").write_text(json.dumps(entry))
    bench = spec.benchmark()
    bench = dict(bench, workloads=bench["workloads"] + [{"name": "quiet-live", **{k: entry[k] for k in ("config", "traffic", "chips", "why")}}])
    cell = _tiny.cell("quiet-live", tmp, here=str(here), bench=bench)
    assert spec.family(cell).__file__ == str(here / "families" / "quiet.py")
    _, result = _run(cell)
    assert result["correct"] is False and result["failed"] == 0
    assert result["check"]["mel_db"]["value"] > result["check"]["mel_db"]["limit"]


def _broken(monkeypatch, fault):
    from gonova_tts_tpu_torch.engine import engine as engine_mod

    served = engine_mod.TTSEngine.synthesize_batch

    def half_left_out(self, texts, *a, **kw):
        out = served(self, texts, *a, **kw)
        keep = -(-len(out) // 2)
        return out[:keep] + [out[0]] * (len(out) - keep)

    def answer_scaled(self, texts, *a, **kw):
        return [x * np.float32(0.25) for x in served(self, texts, *a, **kw)]

    monkeypatch.setattr(engine_mod.TTSEngine, "synthesize_batch", {"half": half_left_out, "scaled": answer_scaled}[fault])


@pytest.mark.parametrize("name", ["hifigan-narrate", "vocos-live"])
@pytest.mark.parametrize("fault", ["half", "scaled"])
def test_a_broken_path_is_not_correct(tmp, monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    cell = _tiny.cell(name, tmp, family=FAMILY.get(name, "vocos"), sample=40)
    if name == "vocos-live":  # batches of more than one request
        cell.mix.update(rate=12.0)
    _, result = _run(cell, seconds=3.0)
    assert result["correct"] is False
    assert any(result["check"][k]["value"] > result["check"][k]["limit"] for k in ("mel_db", "frames_pct"))


def test_the_control_is_not_correct():
    """The float8 reference in the program's place, on the demo checkpoint at its
    served widths, fails the cell's limits; the float32 reference against itself
    reads 0."""
    torch.set_num_threads(4)
    cell = spec.load_cell("vocos-live")
    ctl = control.read_seed(cell, SEED, "fp8", "cpu", pool=12)
    assert ctl["correct"] is False
    same = control.read_seed(cell, SEED, "fp32", "cpu", pool=6)
    assert same["correct"] is True and same["numbers"]["mel_db"]["value"] == 0.0
