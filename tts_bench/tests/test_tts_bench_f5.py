"""The f5 family at a tiny size on the CPU: the family's interface, the weights'
count at published widths, the operations of a pass against a hand count, the
transcript rule shared by the loop and the judge, the two per-layer readers on a
synthetic probe, a whole run of the cell through run.execute, and the float8
control's numbers."""

from __future__ import annotations

import asyncio
import copy
import types

import pytest
import torch

from tts_bench import control, prompts, run, spec, trace
from tts_bench.tests.test_tts_bench_layout import assert_family
from tts_bench.voices import Voice
from tts_bench.weights import f5 as weights

SEED = 2**33 + 29
TINY = {"f5_dim": 64, "f5_depth": 2, "f5_heads": 4, "f5_text_dim": 32, "f5_conv_layers": 1, "f5_nfe_steps": 4,
        "vocos_dim": 32, "vocos_ff": 64, "vocos_layers": 1, "compute_dtype": "float32"}


def tiny_cell(**mix) -> spec.Cell:
    """f5-narrate at TINY widths with a light mix."""
    cell = copy.deepcopy(spec.load_cell("f5-narrate", bench=spec.benchmark()))
    cell.config["model"] = dict(cell.config["model"], **TINY)
    light = {"clients": 2, "ramp_s": 0.5, "sample": 3, "trace_at_s": 0.5, "trace_s": 0.5,
             "doc_sentences": {"dist": "uniform", "min": 2, "max": 3},
             "words": {"dist": "uniform", "min": 3, "max": 8},
             "warmup_shapes": [[1, 1280], [2, 1280]]}
    cell.mix.update(light, **mix)
    return cell


def test_the_family_resolves_and_exposes_the_interface():
    cell = spec.load_cell("f5-narrate", bench=spec.benchmark())
    family = spec.family(cell)
    assert family.__file__.endswith("families/f5.py")
    assert_family(family)
    assert family.VOCODER_FORWARDS == ("vocos",)
    assert all(callable(getattr(family, f)) for f in ("dit_ops", "dit_bytes", "install"))
    names = {m["name"] for m in cell.per_layer}
    assert {"dit_roofline.f5", "frame_fill.f5", "step_mfu.narrate", "vocoder_roofline.narrate",
            "batch_fill.narrate", "device_idle.narrate"} == names
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "audio_s_per_s"]
    with pytest.raises(ValueError):
        family.vocoder_ops(dict(cell.config["model"], acoustic_family="nova"), 1, 100)


def _published() -> dict:
    from gonova_tts_tpu_torch.config import ModelConfig

    return ModelConfig(**spec.load_cell("f5-narrate").config["model"]).model_dump()


def test_the_weights_count_336m_dit_parameters():
    m = _published()
    d, td, ff = 1024, 512, 2048
    block = 6 * d * d + 6 * d + 4 * (d * d + d) + (d * ff + ff) + (ff * d + d)
    text = 2546 * td + 4 * (8 * td + 2 * td + (td * 2 * td + 2 * td) + 4 * td + (2 * td * td + td))
    rest = (712 * d + d) + 2 * (31 * 64 * d + d) + (256 * d + d) + (d * d + d) + (d * 2 * d + 2 * d) + (d * 100 + 100)
    assert weights.dit_params(m) == 22 * block + text + rest
    assert abs(weights.dit_params(m) - 336e6) < 2e6
    leaves = dict((p, s) for p, s, _, _ in weights.dit_leaves(m))
    assert leaves["acoustic/blocks/21/ada/w"] == (1024, 6144) and leaves["acoustic/proj_out/w"] == (1024, 100)
    stds = {p: s for p, _, s, _ in weights.dit_leaves(m)}
    assert stds["acoustic/blocks/0/ada/w"] > 0 and stds["acoustic/norm_out/w"] > 0 and stds["acoustic/proj_out/w"] > 0


def test_pass_ops_per_audio_second_at_l_1500():
    """2 rows x 32 steps x (2 x 189.5 M multiply-adds a frame + 4 L d x 22 of
    attention) at L = 1,500, over the 563 generated frames (6.0 s) of a 10 s prompt."""
    family, m = spec.module("families", "f5"), _published()
    macs = 22 * 8 * 1024**2 + 2 * 31 * 64 * 1024 + 712 * 1024 + 1024 * 100
    assert abs(macs - 189.5e6) < 0.1e6
    per_frame = 2 * macs + 4 * 1500 * 1024 * 22
    hand = 2 * 32 * 1500 * per_frame / ((1500 - 937) * 256 / 24000)
    got = family.pass_ops(m, ("f5", 1, 1500)) / ((1500 - 937) * 256 / 24000)
    assert abs(got / hand - 1) < 0.01 and abs(got / 8.2e12 - 1) < 0.02


def test_the_loop_and_the_judge_agree_on_the_transcript(tmp_path):
    from gonova_tts_tpu_torch.text.chars import read_text, with_stop

    cell = tiny_cell()
    loop = spec.loop(cell)
    voices = [Voice(SEED, i, sr) for i, sr in enumerate(loop.voice_rates(cell.mix))]
    registered = {}

    class Svc:
        batcher = types.SimpleNamespace(submit=None)

        async def register_voice(self, voice_id, b64, reference_text=None):
            registered[voice_id] = reference_text

        async def synthesize_full(self, text, voice_id="default"):
            return None

    asyncio.run(loop.warm(Svc(), cell.mix, voices))
    assert list(registered) == ["voice0", "voice1", "voice2"]
    cfg = run_config(cell, tmp_path)
    judge = spec.family(cell).judge(cfg.model.model_dump(), cfg.engine.model_dump(), cfg.model.model_path, "cpu")
    for i, v in enumerate(voices):
        text = registered[f"voice{i}"]
        assert text == prompts.transcript(v.wav) and len(text.split()) == prompts.WORDS
        assert judge.speaker(f"v{i}", v.wav)["text"] == with_stop(read_text(text))
    assert len(set(registered.values())) == 3
    assert prompts.transcript(voices[0].wav) != prompts.transcript(Voice(SEED + 1, 0, 24000).wav)


def run_config(cell, tmp_path):
    from tts_bench import serve

    return serve.port_config(cell, SEED, "cpu", str(tmp_path))


def _ctx(stats0, stats1, ranges=(), model=None):
    probe = types.SimpleNamespace(counters0={"stats": stats0}, counters1={"stats": stats1},
                                  device={"ranges": list(ranges)})
    return types.SimpleNamespace(probe=probe, cell=spec.load_cell("f5-narrate"), model=model or _published())


def test_frame_fill_and_dit_roofline_by_hand():
    frame_fill, dit = spec.reader("frame_fill.f5"), spec.reader("dit_roofline.f5")
    ctx = _ctx({"f5_real_frames": 100, "f5_padded_frames": 200}, {"f5_real_frames": 1100, "f5_padded_frames": 1450})
    assert frame_fill.read(ctx) == pytest.approx(80.0)
    assert frame_fill.read(_ctx({}, {"f5_real_frames": 0, "f5_padded_frames": 0})) is None
    assert frame_fill.read(_ctx({}, {})) is None  # a program without the counters
    assert frame_fill.read(types.SimpleNamespace(probe=None)) is None

    family, m = spec.module("families", "f5"), _published()
    ops, nbytes = family.dit_ops(m, 4, 1536), family.dit_bytes(m, 4, 1536)
    assert ops / 989e12 > nbytes / 3.35e12  # compute-bound
    ranges = [("tts_bench.f5:4x1536", 2 * 1e6 * ops / 989e12), ("tts_bench.vocoder:4x1536", 5.0)]
    assert dit.read(_ctx({}, {}, ranges, m)) == pytest.approx(50.0)
    assert dit.read(_ctx({}, {}, [("tts_bench.vocoder:4x1536", 5.0)], m)) is None
    assert dit.read(types.SimpleNamespace(probe=None)) is None


def test_install_counts_and_ranges_each_sampler_call():
    from gonova_tts_tpu_torch.models import f5

    family, probe = spec.module("families", "f5"), trace.Probe()
    calls = []
    orig = f5.sample
    try:
        stub = f5.sample = lambda params, ids1, *a, **k: calls.append(ids1.shape) or "mel"
        family.install(None, probe)
        assert f5.sample(None, torch.zeros(3, 1280)) == "mel"
        assert probe.passes == {("f5", 3, 1280): 1} and calls == [(3, 1280)]
        probe.unpatch()
        assert f5.sample is stub and probe.passes == {("f5", 3, 1280): 1}
    finally:
        f5.sample = orig


@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_run_of_the_cell_is_correct(trace_on):
    torch.set_num_threads(4)
    cell = tiny_cell()
    args = run.parse(["--workload", "f5-narrate", "--seed", str(SEED), "--seconds", "3", "--trace", str(trace_on)])
    code, info, result = run.execute(args, "cpu", cell=cell)
    assert code == 0 and result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["check"]["mel_db"]["value"] < 0.01 and result["check"]["frames_pct"]["value"] == 0.0
    wanted = cell.per_layer if trace_on else cell.end_to_end
    for m in wanted:
        if m["source"] != "device_trace":
            assert m["name"] in result["metrics"], m["name"]
    if trace_on:
        assert 0 < result["metrics"]["frame_fill.f5"]["value"] <= 100
        assert result["metrics"]["step_mfu.narrate"]["value"] > 0


def test_the_float8_control_is_not_correct():
    """At the tiny widths the control reads ~0.2 dB (at published widths, PERF.md's
    readings), a served run under 0.01: the tiny cell's limit lies between."""
    torch.set_num_threads(4)
    cell = tiny_cell(sample=2)
    cell.limits = dict(cell.limits, mel_db=0.05)
    out = control.read_seed(cell, SEED, "fp8", "cpu", pool=3)
    assert out["correct"] is False and out["numbers"]["mel_db"]["value"] > cell.limits["mel_db"]
    same = control.read_seed(cell, SEED, "fp32", "cpu", pool=3)
    assert same["numbers"]["mel_db"]["value"] == 0.0 and same["correct"] is True
