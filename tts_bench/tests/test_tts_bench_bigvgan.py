"""The bigvgan family: it resolves and exposes what the harness calls, its weights make
the published generator, its counts are the hand count of the published widths, its
judge is the repository's plain BigVGAN reference bit for bit, `snake_roofline` reads
the hand-computed value, and the cell runs at a tiny size on the CPU."""

from __future__ import annotations

import copy
import math
import os
import types

import numpy as np
import pytest
import torch

from tts_bench import run, serve, spec, voices
from tts_bench.reference.model import Reference as NovaReference
from tts_bench.reference.model import load_tree
from tts_bench.tests import _tiny
from tts_bench.tests.test_tts_bench_layout import assert_family

SEED = 2**33 + 41
CELL = "bigvgan-narrate"
# The generator at a tiny width whose rates multiply to the hop (256).
TINY = dict(_tiny.TINY, vocoder_family="bigvgan", n_mels=20, speaker_n_mels=16, upsample_initial_channel=32,
            upsample_rates=[8, 8, 2, 2], upsample_kernels=[16, 16, 4, 4], resblock_kernels=[3, 7],
            resblock_dilations=[[1, 3], [1, 3]])


def _published() -> dict:
    from gonova_tts_tpu_torch.config import ModelConfig

    return ModelConfig(**spec.load_cell(CELL).config["model"]).model_dump()


def test_the_family_resolves_and_exposes_the_interface():
    cell = spec.load_cell(CELL, bench=spec.benchmark())
    family = spec.family(cell)
    assert family.__file__.endswith("families/bigvgan.py")
    assert_family(family)
    assert family.VOCODER_FORWARDS == ("bigvgan",)
    assert cell.config["reduced"] == [] and cell.config["family"] == "bigvgan"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "audio_s_per_s"]
    assert [m["name"] for m in cell.per_layer] == ["batch_fill.narrate", "pad_efficiency.narrate", "step_mfu.narrate",
                                                   "vocoder_roofline.narrate", "device_idle.narrate",
                                                   "snake_roofline.bigvgan"]
    nova = spec.module("families", "nova")
    with pytest.raises(ValueError):
        nova.vocoder_ops(_published(), 1, 64)  # nova still refuses it
    with pytest.raises(ValueError):
        family.vocoder_ops(dict(_published(), vocoder_family="hifigan"), 1, 64)


def test_the_weights_make_the_published_generator():
    """weights/bigvgan.py's leaves are the port's tree at the published widths, path for
    path and shape for shape: 112,414,512 generator parameters (the hand count), the
    family's `vocoder_params`, and a 256 → 100 mel head."""
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import bigvgan

    m = _published()
    made = {path: shape for path, shape, _ in spec.module("weights", "bigvgan").leaves(m)}
    with torch.device("meta"):
        gen = bigvgan.init(torch.Generator(), ModelConfig(**m))
    port = {f"vocoder/{k.replace('.', '/')}": tuple(v.shape) for k, v in gen.state_dict().items()}
    assert {k: v for k, v in made.items() if k.startswith("vocoder/")} == port
    assert made["acoustic/mel_out/w"] == (256, 100) and made["acoustic/mel_out/b"] == (100,)
    n = sum(math.prod(s) for k, s in made.items() if k.startswith("vocoder/"))
    chans = [1536 // 2 ** (i + 1) for i in range(6)]
    by_hand = (7 * 100 * 1536 + 1536 + sum(k * 2 * c * c + c for k, c in zip([8, 8, 4, 4, 4, 4], chans))
               + sum(126 * c * c + 18 * c + 36 * c for c in chans) + 2 * 24 + 7 * 24)
    assert n == by_hand == 112_414_512 == spec.family(spec.load_cell(CELL)).vocoder_params(m)


def test_made_weights_are_seeded_and_scaled():
    weights = spec.module("weights", "bigvgan")
    m = dict(_published(), **{k: v for k, v in TINY.items() if k != "compute_dtype"})
    a, b = weights.make(m, SEED, "cpu"), weights.make(m, SEED, "cpu")
    assert all(np.array_equal(a[k], b[k]) and a[k].dtype == np.float16 for k in a)
    assert not np.array_equal(a["vocoder/ups/0/w"], weights.make(m, SEED + 1, "cpu")["vocoder/ups/0/w"])
    ups = np.concatenate([a[k].ravel() for k in a if "/amps/" in k and k.endswith("/w")]).astype(np.float64)
    assert ups.std() == pytest.approx(0.01, rel=0.05)
    logs = np.concatenate([a[k].ravel() for k in a if k.endswith(("alpha", "beta"))]).astype(np.float64)
    assert logs.std() == pytest.approx(0.1, rel=0.15)
    assert "vocoder/conv_post/b" not in a


def test_counts_per_audio_second_are_the_hand_count():
    """At the published widths, per audio-second (93.75 frames at hop 256, 24 kHz):
    convs 1.69e11 FLOP, activations 57.6 M channel-samples at 58 operations each; the
    bytes of one activation 2 * 2 * B C T + 8 C."""
    family, m = spec.family(spec.load_cell(CELL)), _published()
    frames = 9375  # 100 s
    assert family.conv_ops(m, 1, frames) / 100 == pytest.approx(1.69e11, rel=0.005)
    samples = sum(b * c * t for b, c, t in family.snake_shapes(m, 1, frames)) / 100
    assert samples == 57.6e6 and len(family.snake_shapes(m, 1, frames)) == 109
    assert family.vocoder_ops(m, 1, frames) / 100 == pytest.approx(1.69e11 + 58 * 57.6e6, rel=0.005)
    assert family.snake_bytes(16, 768, 1792) == 2 * 2 * 16 * 768 * 1792 + 8 * 768
    key = ("dec", 4, 64, 320)
    nova = spec.module("families", "nova")
    local = 64 * m["max_frames_per_token"] >= m["local_attention_min_frames"]
    assert family.pass_ops(m, key) == nova.flops.decode(m, 4, 320, local) + family.vocoder_ops(m, 4, 320)
    assert family.pass_ops(m, ("enc", 4, 64)) == nova.pass_ops(m, ("enc", 4, 64))


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import tts

    path = str(tmp_path_factory.mktemp("bigvgan") / "tiny_bigvgan.npz")
    model = tts.TTS(ModelConfig(**TINY), torch.Generator().manual_seed(7))
    np.savez(path, **{k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()})
    return path


def test_the_judge_is_the_programs_reference_bit_for_bit(tiny_checkpoint):
    """At the tiny widths: the family's judge vocodes a mel bit for bit as the
    repository's reference/bigvgan.py does (both plain f32 PyTorch over one tree), and
    embeds a recording bit for bit as model.py's reference at `speaker_n_mels` bands."""
    import sys

    from gonova_tts_tpu_torch.config import EngineConfig, ModelConfig

    sys.path.insert(0, spec.ROOT)
    from reference import bigvgan as program_ref

    torch.set_num_threads(4)
    model = ModelConfig(**TINY).model_dump()
    judge = spec.module("families", "bigvgan").judge(model, EngineConfig().model_dump(), tiny_checkpoint, "cpu")
    tree, _ = load_tree(tiny_checkpoint, "cpu")
    program = program_ref.BigVGAN(tree["vocoder"], model["upsample_rates"], model["resblock_dilations"])
    mel = torch.randn((1, 30, 20), generator=torch.Generator().manual_seed(1)) * 2.0
    with torch.no_grad():
        assert torch.equal(judge.ref.generator(mel), program(mel))
        t = 17
        assert torch.equal(judge.ref.vocode(mel[0, :t]), program(torch.nn.functional.pad(mel[:, :t], (0, 0, 0, 64)))[0, : t * 256])
    wav = voices.Voice(SEED, 0, 44100).wav
    spk = judge.speaker("v0", wav)
    x, sr = voices_read(wav)
    want = NovaReference(tree, dict(model, n_mels=16), "cpu").embed(x, sr)
    assert np.array_equal(spk, want) and spk.shape == (model["speaker_dim"],)
    audio = judge.speak(judge.sentences("The fox ran home.")[0], spk, 0.5)
    assert audio.dtype == np.float32 and len(audio) > 0 and len(audio) % 256 == 0


def voices_read(wav: bytes):
    from tts_bench.reference import audio

    return audio.read_wav(wav)


def _snake_ctx(cell_name: str, model: dict, launched: int, kernels_s: dict):
    ranges = [("tts_bench.vocoder:4x320", 9000.0), ("tts_bench.vocoder:16x448", 41000.0), ("tts_bench.mel:1x239872", 46.0)]
    stats0, stats1 = {"kernel_launches.snake_aa": 1090}, {"kernel_launches.snake_aa": 1090 + launched}
    probe = types.SimpleNamespace(device={"ranges": ranges, "kernels_s": kernels_s},
                                  counters0={"stats": stats0, "spans": {}}, counters1={"stats": stats1, "spans": {}})
    return types.SimpleNamespace(cell=spec.load_cell(cell_name), model=model, probe=probe)


def test_snake_roofline_by_hand():
    """100 * the activations' least time (each max(58 B C T / 67e12, (4 B C T + 8 C) /
    3.35e12) over every activation of the ranged forwards) / the named kernels' device
    time; None without launches in the window, without a probe, and for a family that
    counts no activation."""
    read, m = spec.reader("snake_roofline.bigvgan").read, _published()
    kernels = {"void (anonymous namespace)::snake_aa_kernel<__nv_bfloat16, true>(...)": 0.0125, "nchwToNhwcKernel": 0.3}
    least = 0.0
    for b, frames in ((4, 320), (16, 448)):
        for i, c in enumerate([768, 384, 192, 96, 48, 24]):
            t = frames * [4, 16, 32, 64, 128, 256][i]
            least += 18 * max(58 * b * c * t / 67e12, (4 * b * c * t + 8 * c) / 3.35e12)
        least += max(58 * b * 24 * frames * 256 / 67e12, (4 * b * 24 * frames * 256 + 8 * 24) / 3.35e12)
    assert read(_snake_ctx(CELL, m, 2 * 109, kernels)) == pytest.approx(100.0 * least / 0.0125, rel=1e-12)
    assert read(_snake_ctx(CELL, m, 0, kernels)) is None  # no launch: a program without the kernel
    assert read(types.SimpleNamespace(probe=None)) is None
    none = _snake_ctx(CELL, m, 218, kernels)
    none.probe.counters1["stats"] = {}  # a program without the counter
    assert read(none) is None
    assert read(_snake_ctx("hifigan-narrate", m, 218, kernels)) is None  # nova counts no activation


def test_the_cell_runs_at_a_tiny_size(tmp_path):
    """bigvgan-narrate's files at the tiny widths (the generator and the 20-band head
    made by weights/bigvgan.py over a tiny checkpoint's acoustic model and 16-band
    speaker encoder): a traced run on the CPU is correct and reports the per-layer
    metrics that need no device. The window is 6 s: in 2.5 s the CPU's plain activation
    sometimes finished no document, and nothing was judged."""
    torch.set_num_threads(4)
    base = _tiny.cell("hifigan-narrate", str(tmp_path), family="vocos")
    cell = copy.deepcopy(spec.load_cell(CELL, bench=spec.benchmark()))
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import tts

    ck = str(tmp_path / "tiny_acoustic.npz")
    model = tts.TTS(ModelConfig(**TINY), torch.Generator().manual_seed(3))
    np.savez(ck, **{k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()
                    if k.startswith(("acoustic", "speaker"))})
    cell.config = dict(cell.config, checkpoint=ck, model=dict(cell.config["model"], **TINY), engine={})
    cell.mix = dict(base.mix)
    args = run.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", "6", "--trace", "1"])
    code, info, result = run.execute(args, "cpu", cell=cell)
    assert code == 0 and result["correct"] is True and result["attempted"] > 0, result["check"]
    assert {"batch_fill.narrate", "pad_efficiency.narrate", "step_mfu.narrate"} <= set(result["metrics"]) \
        <= {m["name"] for m in cell.per_layer}
    cfg = serve.port_config(cell, SEED, "cpu", str(tmp_path))
    assert os.path.basename(cfg.model.model_path) == "served.npz"
    with np.load(cfg.model.model_path) as z:
        assert z["acoustic/mel_out/w"].shape == (32, 20) and z["speaker/c1/w"].shape == (5, 16, 256)
