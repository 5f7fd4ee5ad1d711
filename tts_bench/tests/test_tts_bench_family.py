"""The nova family delegates and changes nothing: its judge is check.Judge, its counts
are flops.py's, and the readers that take their counts from a cell's family read what
the formulas they replaced read. The engine's counters and span histograms are
snapshotted at the window's edges, and the two readers of that snapshot give the
hand-computed value."""

from __future__ import annotations

import itertools
import types

import numpy as np
import pytest
import torch

from tts_bench import check, flops, serve, spec, trace, voices
from tts_bench.tests import _tiny

SEED = 2**33 + 29
CELLS = {"vocos-live": "vocos", "hifigan-narrate": "hifigan"}  # a cell of each configuration, its vocoder family
TEXT = "Every morning the baker opened his shop before the sun rose over the hills. She said nothing."


def _model(config_name: str) -> dict:
    from gonova_tts_tpu_torch.config import ModelConfig

    return ModelConfig(**spec._read(f"{spec.HERE}/configs/{config_name}.json")["model"]).model_dump()


MODELS = [c["name"] for c in spec.benchmark()["configs"]]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_family_judge_is_check_judge(tmp_path, name):
    """At the tiny widths: the judge the cell's family builds embeds a recording and
    speaks a sentence bit for bit as check.Judge built directly does."""
    torch.set_num_threads(4)
    cell = _tiny.cell(name, str(tmp_path), family=CELLS[name])
    cfg = serve.port_config(cell, SEED, "cpu", str(tmp_path))
    args = (cfg.model.model_dump(), cfg.engine.model_dump(), cfg.model.model_path, "cpu")
    family = spec.family(cell)
    assert family.__file__.endswith("families/nova.py")
    mine, direct = family.judge(*args), check.Judge(*args)
    wav = voices.Voice(SEED, 0, 44100).wav
    spk = mine.speaker("v0", wav)
    assert np.array_equal(spk, direct.speaker("v0", wav))
    assert mine.sentences(TEXT) == direct.sentences(TEXT)
    for s in mine.sentences(TEXT):
        assert np.array_equal(mine.speak(s, spk, 0.5), direct.speak(s, spk, 0.5))


GRID = list(itertools.product((1, 4, 16), (32, 96, 192), (128, 448, 1536)))


@pytest.mark.parametrize("config_name", MODELS)
def test_counts_are_flops(config_name):
    """Over a grid of (batch, token bucket, frame bucket): the family's counts equal
    flops.py's, and a pass's two keys add up to flops.pass_flops."""
    m, nova = _model(config_name), spec.module("families", "nova")
    for b, length, frames in GRID:
        assert nova.pass_ops(m, ("enc", b, length)) == flops.encode(m, b, length)
        assert nova.pass_ops(m, ("enc", b, length)) + nova.pass_ops(m, ("dec", b, length, frames)) == \
            flops.pass_flops(m, b, length, frames)
        assert nova.vocoder_ops(m, b, frames) == flops.vocoder(m, b, frames)
        assert nova.vocoder_bytes(m, b, frames) == flops.vocoder_bytes(m, b, frames)


def test_nova_refuses_another_vocoder():
    nova = spec.module("families", "nova")
    m = dict(_model("nova-hifigan-v1"), vocoder_family="bigvgan")
    for call in (lambda: nova.vocoder_ops(m, 1, 64), lambda: nova.vocoder_bytes(m, 1, 64),
                 lambda: nova.pass_ops(m, ("dec", 1, 32, 64))):
        with pytest.raises(ValueError):
            call()


def _parent_step_mfu(ctx):
    """step_mfu's formula before the counts came from the family."""
    m, ops = ctx.model, 0
    for key, n in ctx.probe.passes1.items():
        n -= ctx.probe.passes0.get(key, 0)
        if key[0] == "enc":
            ops += n * flops.encode(m, key[1], key[2])
        else:
            _, b, length, frames = key
            local = length * m["max_frames_per_token"] >= m["local_attention_min_frames"]
            ops += n * (flops.decode(m, b, frames, local) + flops.vocoder(m, b, frames))
    return 100.0 * ops / ctx.window.seconds / flops.PEAK_BF16 if ops else None


def _parent_vocoder_roofline(ctx):
    """vocoder_roofline's formula before the counts came from the family."""
    m, least, device_us = ctx.model, 0.0, 0.0
    for name, dev_us in ctx.probe.device["ranges"]:
        if name.startswith("tts_bench.vocoder:"):
            b, t = (int(x) for x in name.split(":")[1].split("x"))
            least += flops.least_seconds(flops.vocoder(m, b, t), flops.vocoder_bytes(m, b, t), flops.PEAK_BF16)
            device_us += dev_us
    return 100.0 * least / (device_us / 1e6) if device_us > 0 else None


def synthetic_ctx(cell_name: str, model: dict):
    """A run's context as the readers see it: passes counted at the window's edges,
    the traced sub-window's vocoder ranges."""
    passes0 = {("enc", 1, 32): 7, ("dec", 1, 32, 128): 7, ("enc", 4, 96): 2}
    passes1 = {("enc", 1, 32): 40, ("dec", 1, 32, 128): 40, ("enc", 4, 96): 9, ("dec", 4, 96, 448): 7,
               ("enc", 16, 192): 3, ("dec", 16, 192, 1536): 3}
    ranges = [("tts_bench.vocoder:1x128", 812.5), ("tts_bench.vocoder:4x448", 2950.25), ("tts_bench.mel:1x239872", 46.0),
              ("tts_bench.vocoder:16x1536", 40210.0)]
    probe = types.SimpleNamespace(passes0=passes0, passes1=passes1, device={"ranges": ranges})
    return types.SimpleNamespace(cell=spec.load_cell(cell_name), model=model, probe=probe,
                                 window=types.SimpleNamespace(seconds=50.0))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_readers_read_as_before(name):
    ctx = synthetic_ctx(name, _model(spec.load_cell(name).config_name))
    for metric, parent in (("step_mfu", _parent_step_mfu), ("vocoder_roofline", _parent_vocoder_roofline)):
        value = spec.reader(metric).read(ctx)
        assert value is not None and value == parent(ctx), metric


# ---------------------------------------------------------------- the snapshot


def test_snapshot_on_a_cpu_engine(tmp_path):
    """`trace.counters` of a CPU engine after two passes: the fixed dicts as before,
    every engine number by its dotted name, and every span's histogram."""
    from gonova_tts_tpu_torch.config import Config
    from gonova_tts_tpu_torch.engine import TTSEngine

    torch.set_num_threads(4)
    cfg = Config()
    for k, v in _tiny.TINY.items():
        setattr(cfg.model, k, v)
    cfg.model.model_path = _tiny.checkpoint(str(tmp_path / "tiny.npz"))
    cfg.engine.warmup_shapes = []
    engine = TTSEngine(cfg, device="cpu")
    engine.load(warmup=False)
    svc = types.SimpleNamespace(synthesizer=types.SimpleNamespace(engine=engine),
                                batcher=types.SimpleNamespace(metrics={"requests": 3, "batches": 2}))
    before = trace.counters(svc)
    engine.synthesize_batch(["She said nothing."])
    engine.synthesize_batch(["The fox ran.", "It was late."])
    after = trace.counters(svc)
    assert list(after) == ["batcher", "engine", "stats", "spans"]
    assert after["batcher"] == {"requests": 3, "batches": 2}
    assert set(after["engine"]) == {"real_tokens", "padded_tokens", "batches", "batched_requests"}
    stats = after["stats"]
    assert stats["graph_passes"] - before["stats"]["graph_passes"] == 0  # the CPU never graphs
    assert stats["eager_passes"] - before["stats"]["eager_passes"] == 2
    assert stats["batches"] == after["engine"]["batches"]
    assert not any(k.startswith("timers") for k in stats)
    assert all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in stats.values())
    assert any(k.startswith("g2p_tiers.") for k in stats)
    span = after["spans"]["engine.pass"]
    assert span["count"] - before["spans"].get("engine.pass", {"count": 0})["count"] == 2
    assert span["sum_s"] > 0 and span["buckets"][-1] == span["count"]
    ctx = types.SimpleNamespace(probe=types.SimpleNamespace(counters0=before, counters1=after))
    assert trace.delta(ctx, "eager_passes") == 2
    assert trace.span_window(ctx, "engine.pass")["count"] == 2


def _hist(count: int, sum_s: float, buckets):
    return {"count": count, "sum_s": sum_s, "buckets": list(buckets), "min_s": 0.001, "max_s": 0.2}


def snapshot_ctx(stats0, stats1, spans0, spans1):
    probe = types.SimpleNamespace(counters0={"stats": stats0, "spans": spans0}, counters1={"stats": stats1, "spans": spans1})
    return types.SimpleNamespace(probe=probe)


def test_delta_and_span_window():
    ctx = snapshot_ctx({"a": 5, "g2p_tiers.lexicon": 2}, {"a": 12, "g2p_tiers.lexicon": 9, "g2p_tiers.neural": 4},
                       {"s": _hist(2, 0.5, [1, 2, 2])}, {"s": _hist(7, 1.75, [1, 5, 7]), "t": _hist(3, 0.03, [3, 3, 3])})
    assert trace.delta(ctx, "a") == 7 and trace.delta(ctx, "g2p_tiers.lexicon") == 7
    assert trace.delta(ctx, "g2p_tiers.neural") == 4  # absent at the start: counted from 0
    assert trace.delta(ctx, "missing") is None
    assert trace.span_window(ctx, "s") == {"count": 5, "sum_s": 1.25, "buckets": [0, 3, 5]}
    assert trace.span_window(ctx, "t") == {"count": 3, "sum_s": 0.03, "buckets": [3, 3, 3]}
    assert trace.span_window(ctx, "missing") is None
    none = types.SimpleNamespace(probe=None)
    assert trace.delta(none, "a") is None and trace.span_window(none, "s") is None


def test_graph_hit_by_hand():
    read = spec.reader("graph_hit.live").read
    # 416 of 448 passes replayed: 100 * 416 / 448
    ctx = snapshot_ctx({"graph_passes": 10, "eager_passes": 2}, {"graph_passes": 426, "eager_passes": 34}, {}, {})
    assert read(ctx) == pytest.approx(92.857142857142857, rel=1e-12)
    idle = snapshot_ctx({"graph_passes": 10, "eager_passes": 2}, {"graph_passes": 10, "eager_passes": 2}, {}, {})
    assert read(idle) is None  # no pass in the window
    assert read(types.SimpleNamespace(probe=None)) is None
    assert read(snapshot_ctx({}, {"eager_passes": 5}, {}, {})) is None  # a program without the counter


def test_pass_ms_mean_by_hand():
    read = spec.reader("pass_ms_mean.live").read
    spans0 = {"engine.pass": _hist(100, 1.0, [40, 100]), "engine.embed_voice": _hist(3, 0.05, [3, 3])}
    spans1 = {"engine.pass": _hist(548, 3.4, [300, 548]), "engine.embed_voice": _hist(9, 0.2, [9, 9])}
    # 2.4 s over 448 passes
    assert read(snapshot_ctx({}, {}, spans0, spans1)) == pytest.approx(1e3 * 2.4 / 448, rel=1e-12)
    assert read(snapshot_ctx({}, {}, spans1, spans1)) is None  # no pass in the window
    assert read(snapshot_ctx({}, {}, {}, {})) is None  # never recorded
    assert read(types.SimpleNamespace(probe=None)) is None
