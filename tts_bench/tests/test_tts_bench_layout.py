"""The benchmark is driven by data: every cell, configuration, mix and metric is a
file found by its name, BENCHMARK.json agrees with those files and keeps to the
contract's shapes, and a cell added as one file needs no other edit."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from tts_bench import spec

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
    for kind in ("workloads", "configs", "traffic", "loops", "weights", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, kind), here / kind)
    new = {"config": "nova-hifigan-v1", "traffic": "live", "chips": 1, "why": "a later cell",
           "params": {"rate": 3.0}, "limits": {"mel_db": 0.6, "frames_pct": 1.5}}
    (here / "workloads" / "hifigan-live.json").write_text(json.dumps(new))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [{"name": "hifigan-live", **{k: new[k] for k in ("config", "traffic", "chips", "why")}}])
    cell = spec.load_cell("hifigan-live", here=str(here), bench=bench)
    assert cell.mix["rate"] == 3.0 and cell.mix["loop"] == "open"
    assert spec.loop(cell).__file__ == str(here / "loops" / "open.py")
    assert cell.config["model"]["vocoder_family"] == "hifigan"
    assert "hifigan-live" in spec.names("workloads", str(here))
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]


def test_dotted_metric_falls_back_to_its_reader():
    assert spec.reader("batch_fill.some_new_cell").LAYER == "batcher"
    with pytest.raises(KeyError):
        spec.reader("no_such_metric.live")
