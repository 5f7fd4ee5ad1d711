"""The benchmark is driven by data: every cell, configuration, mix, model family and
metric is a file found by its name, BENCHMARK.json agrees with those files and keeps
to the contract's shapes, and a cell or a family added as files needs no other edit."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import sys
import types

import pytest

from tts_bench import flops, spec, trace

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["tts_bench"]
    assert BENCH["command"] == ["python3", "tts_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file_is_the_entry(entry):
    assert spec.as_entry(entry["name"]) == entry
    cell = spec.load_cell(entry["name"], bench=BENCH)
    assert cell.chips == 1 and len(cell.why) <= 200 and "\n" not in cell.why
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert set(cell.limits) == {"mel_db", "frames_pct"}


def test_every_file_is_named_and_used():
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(spec.names("workloads")) == cells
    assert set(spec.names("configs")) == {c["name"] for c in BENCH["configs"]}
    assert set(spec.names("traffic")) == {c["traffic"] for c in BENCH["workloads"]}
    loops = {spec.load_cell(c["name"]).mix["loop"] for c in BENCH["workloads"]}
    assert loops <= set(spec.names("loops"))
    for name in spec.names("loops"):
        mod = spec.module("loops", name)
        assert all(callable(getattr(mod, f)) for f in ("voice_rates", "voice_id", "requests", "warm", "trace_at", "run"))
    for c in BENCH["configs"]:
        assert c["file"] == f"tts_bench/configs/{c['name']}.json"
        assert json.load(open(os.path.join(spec.ROOT, c["file"])))["name"] == c["name"]
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    families = {spec.family(spec.load_cell(c["name"])).__name__.rsplit(".", 1)[1] for c in BENCH["workloads"]}
    assert families == set(spec.names("families"))
    for name in spec.names("families"):
        assert_family(spec.module("families", name))


def assert_family(mod) -> None:
    """A family module exposes what the harness calls (spec.py's docstring)."""
    assert all(callable(getattr(mod, f)) for f in ("judge", "pass_ops", "vocoder_ops", "vocoder_bytes"))
    assert isinstance(mod.VOCODER_FORWARDS, tuple) and all(isinstance(n, str) for n in mod.VOCODER_FORWARDS)
    assert callable(getattr(mod, "install", lambda svc, probe: None))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_agrees(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    mod = spec.reader(metric["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (metric["unit"], metric["better"], metric["source"])
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "layer" in metric:
        assert mod.LAYER == metric["layer"]
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25


def test_a_cell_dropped_in_is_found(tmp_path):
    here = tmp_path / "tts_bench"
    for kind in ("workloads", "configs", "traffic", "loops", "families", "weights", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, kind), here / kind)
    new = {"config": "nova-hifigan-v1", "traffic": "live", "chips": 1, "why": "a later cell",
           "params": {"rate": 3.0}, "limits": {"mel_db": 0.6, "frames_pct": 1.5}}
    (here / "workloads" / "hifigan-live.json").write_text(json.dumps(new))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [{"name": "hifigan-live", **{k: new[k] for k in ("config", "traffic", "chips", "why")}}])
    cell = spec.load_cell("hifigan-live", here=str(here), bench=bench)
    assert cell.mix["rate"] == 3.0 and cell.mix["loop"] == "open"
    assert spec.loop(cell).__file__ == str(here / "loops" / "open.py")
    assert cell.config["model"]["vocoder_family"] == "hifigan"
    assert spec.family(cell).__file__ == str(here / "families" / "nova.py")
    assert "hifigan-live" in spec.names("workloads", str(here))
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]


TOY = '''"""A toy family: its own reference and vocoder module, nova's counts doubled."""

from tts_bench import spec

NOVA = spec.module("families", "nova")
VOCODER_FORWARDS = ("toyvoc",)


class Judge:
    def __init__(self, *args):
        self.args = args


def judge(model, engine, checkpoint, device, numerics="fp32"):
    return Judge(model, engine, checkpoint, device, numerics)


def pass_ops(m, key):
    return 2 * NOVA.pass_ops(m, key)


def vocoder_ops(m, b, frames):
    return 2 * NOVA.vocoder_ops(m, b, frames)


def vocoder_bytes(m, b, frames):
    return 3 * NOVA.vocoder_bytes(m, b, frames)


def install(svc, probe):
    probe.toy_installed = svc
'''


def _digests(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for d, _, files in os.walk(root) for f in files if "__pycache__" not in d}


def test_a_family_dropped_in_is_found(tmp_path, monkeypatch):
    """A new model family is a module, a configuration that names it and a cell, each a
    new file: the harness finds the family in a copy of the folder, takes the judge and
    the counts from it, ranges the forward of the port module it names and calls its
    `install`, and no copied file changes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    here = tmp_path / "tts_bench"
    for kind in ("workloads", "configs", "traffic", "loops", "families", "weights", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, kind), here / kind)
    copied = _digests(here)
    (here / "families" / "toy.py").write_text(TOY)
    config = dict(json.load(open(here / "configs" / "nova-vocos-demo.json")), name="toy-demo", family="toy")
    (here / "configs" / "toy-demo.json").write_text(json.dumps(config))
    entry = {"config": "toy-demo", "traffic": "live", "chips": 1, "why": "a later family",
             "params": {}, "limits": {"mel_db": 0.5, "frames_pct": 1.0}}
    (here / "workloads" / "toy-live.json").write_text(json.dumps(entry))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [{"name": "toy-live", **{k: entry[k] for k in ("config", "traffic", "chips", "why")}}])
    cell = spec.load_cell("toy-live", here=str(here), bench=bench)
    family = spec.family(cell)
    assert family.__file__ == str(here / "families" / "toy.py") and "toy" in spec.names("families", str(here))
    assert_family(family)
    assert family.judge({}, {}, "ck.npz", "cpu").args == ({}, {}, "ck.npz", "cpu", "fp32")

    from tts_bench.tests.test_tts_bench_family import _model, synthetic_ctx

    m = _model("nova-vocos-demo")
    nova = synthetic_ctx("vocos-live", m)
    toy = types.SimpleNamespace(**dict(vars(nova), cell=cell))
    mfu = spec.reader("step_mfu", str(here)).read
    assert mfu(toy) == pytest.approx(2 * mfu(nova), rel=1e-12)
    least = sum(flops.least_seconds(2 * flops.vocoder(m, b, t), 3 * flops.vocoder_bytes(m, b, t), flops.PEAK_BF16)
                for b, t in ((1, 128), (4, 448), (16, 1536)))  # the ranges' shapes; their device time 43,972.75 us
    assert spec.reader("vocoder_roofline", str(here)).read(toy) == pytest.approx(100.0 * least / 43972.75e-6, rel=1e-12)

    toyvoc = types.ModuleType("gonova_tts_tpu_torch.models.toyvoc")
    toyvoc.forward = lambda params, mel: mel * 2
    monkeypatch.setitem(sys.modules, toyvoc.__name__, toyvoc)
    from gonova_tts_tpu_torch.models import vocos

    served, vocos_forward = toyvoc.forward, vocos.forward
    probe, svc = trace.Probe(), object()
    trace.install(svc, probe, family)
    try:
        assert toyvoc.forward is not served and vocos.forward is vocos_forward
        assert probe.toy_installed is svc
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = toyvoc.forward(None, torch.ones(2, 7, 3))
        assert torch.equal(out, torch.full((2, 7, 3), 2.0))
        assert "tts_bench.vocoder:2x7" in {e.name for e in prof.events()}
    finally:
        probe.unpatch()
    assert toyvoc.forward is served
    assert {k: v for k, v in _digests(here).items() if k in copied} == copied


def test_dotted_metric_falls_back_to_its_reader():
    assert spec.reader("batch_fill.some_new_cell").LAYER == "batcher"
    with pytest.raises(KeyError):
        spec.reader("no_such_metric.live")
