"""F5-TTS v1, the port's second acoustic family (`models/f5.py`), on the CPU at a tiny
size: the sampler against the benchmark's plain reference (`tts_bench/reference/
f5.py`), batched rows against rows alone, the host rules (characters, duration,
noise, the time grid), the engine's F5 pass (eager and through replayed graphs), the
service's transcribed voices, streaming, checkpoints, and the nova families left as
they were. Weights come from the benchmark's generator (`tts_bench/weights/f5.py`)
at tiny widths, so that the mel sits at a log-mel's level and the audio is heard in
PCM16.
"""

import asyncio
import base64
import collections
import math
import types

import numpy as np
import pytest
import torch

from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine
from gonova_tts_tpu_torch.models import f5, graphs, params, registry, tts
from gonova_tts_tpu_torch.service.server import TTSService
from gonova_tts_tpu_torch.text.chars import char_ids, read_text, with_stop
from tts_bench.reference import audio as ref_audio
from tts_bench.reference import f5 as reference
from tts_bench.reference.model import load_tree
from tts_bench.voices import speechlike, wav_bytes
from tts_bench.weights import f5 as weights

MODEL = dict(
    acoustic_family="f5", f5_dim=64, f5_depth=2, f5_heads=4, f5_text_dim=32, f5_conv_layers=1, f5_nfe_steps=4,
    n_mels=100, vocos_dim=32, vocos_ff=64, vocos_layers=1, vocos_head="polar", compute_dtype="float32", device="cpu",
)
ENGINE = dict(
    f5_frame_buckets=[512, 640, 768, 1024], batch_buckets=[1, 2, 4], max_batch=4, batch_window_ms=5.0,
    warmup_shapes=[[1, 512], [2, 1024], [4, 640]], stream_chunk_frames=40,
)
TRANSCRIPT = "Morning light fell across the quiet harbor"
SENTENCES = ["Hello there, my friend.", "A rather longer sentence follows, with a comma and more words!",
             "Short one."]
# f32 on the CPU: the port's products run in other shapes and orders than the
# reference's (batched rows, fused q/k/v, F.scaled_dot_product_attention), so the
# generated log-mel differs by float rounding: 1.9e-6 at most at this size.
MEL_F32 = 2e-5
# bf16 products against the f32 reference: 8 mantissa bits through 4 Euler steps of
# 2 blocks move the log-mel (which spans ~10 units here) by 0.08 at most, 0.015 on
# average; the bound leaves that 2.5x.
MEL_BF16 = 0.2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


def _model(**kw) -> ModelConfig:
    return ModelConfig(**{**MODEL, **kw})


def _config(path=None, **engine) -> Config:
    cfg = Config()
    cfg.model = _model(model_path=path)
    cfg.engine = EngineConfig(**{**ENGINE, **engine})
    cfg.logging.level = "WARNING"
    return cfg


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tree = weights.make(_model().model_dump(), 3, "cpu")
    path = str(tmp_path_factory.mktemp("f5") / "f5_tiny.npz")
    np.savez(path, **tree)
    return path


@pytest.fixture(scope="module")
def voice():
    """(WAV bytes of a 3.5 s reference at 44.1 kHz, its transcript)."""
    return wav_bytes(speechlike(11, 0, 44100, seconds=3.5), 44100), TRANSCRIPT


@pytest.fixture(scope="module")
def ref(checkpoint):
    tree, _ = load_tree(checkpoint, "cpu")
    return reference.Reference(tree, _model().model_dump(), "cpu")


@pytest.fixture(scope="module")
def engine(checkpoint):
    eng = TTSEngine(_config(checkpoint), device="cpu")
    eng.load(warmup=False)
    return eng


def _prompt(engine, voice):
    x, sr = ref_audio.read_wav(voice[0])
    return engine.make_prompt(x, sr, voice[1])


def _ref_prompt(ref, voice):
    x, sr = ref_audio.read_wav(voice[0])
    return ref.prompt(x, sr, voice[1])


def _sample(engine, rows, bucket, dtype=torch.float32):
    arrays = engine._f5_arrays(rows, len(rows), bucket)
    ids1, cond, x0, lens, pf, rl, _ = (torch.as_tensor(a) for a in arrays)
    with torch.inference_mode():
        return f5.sample(engine.params["acoustic"], ids1, cond, x0, lens, pf, rl, engine.mcfg, dtype)


# ---------------------------------------------------------------- the sampler


def test_prompt_matches_the_reference(engine, ref, voice):
    p, r = _prompt(engine, voice), _ref_prompt(ref, voice)
    assert p.text == r["text"] and p.ref_len == r["ref_len"] == 3.5 * 24000 // 256
    assert p.frames == p.ref_len + 1 and p.mel.shape == tuple(r["mel"].shape)
    # f32 STFT against rfft of float64-resampled audio: ~1e-3 where the mel nears its floor
    assert np.abs(p.mel - r["mel"].numpy()).max() < 0.02
    assert np.abs(p.mel - r["mel"].numpy()).mean() < 1e-4


@pytest.mark.parametrize("dtype,bound", [(torch.float32, MEL_F32), (torch.bfloat16, MEL_BF16)], ids=["f32", "bf16"])
def test_sampler_matches_the_reference(engine, ref, voice, dtype, bound):
    """Rows of different L in one bucket against the reference, each alone at its L
    from the same prompt (the reference's prompt, so that only the sampler differs)."""
    r = _ref_prompt(ref, voice)
    prompt = f5.Prompt(r["mel"].numpy(), r["text"], r["ref_len"], r["gain"])
    rows = [f5.plan(s, prompt, engine.mcfg) for s in SENTENCES]
    assert len({row.frames for row in rows}) == 3
    bucket = engine.f5_bucket(max(row.frames for row in rows))
    mel = _sample(engine, rows, bucket, dtype)
    for i, (row, s) in enumerate(zip(rows, SENTENCES)):
        want = ref.mel(s, r)
        n = row.frames - row.prompt.ref_len
        assert want.shape[0] == n
        assert float((mel[i, :n] - want).abs().max()) < bound
        assert float(mel[i, n:].abs().max()) == 0.0  # zeros past the row's frames
        assert -12.0 < float(want.min()) and float(want.max()) < 4.0  # a log-mel's range


def test_a_batched_row_equals_the_row_alone(engine, voice):
    """The key mask, the masked convs and GRN, and the noise rule: a row padded to a
    bucket beside other rows gives the generated mel it gives alone at its own L."""
    prompt = _prompt(engine, voice)
    rows = [f5.plan(s, prompt, engine.mcfg) for s in SENTENCES]
    together = _sample(engine, rows, 1024)
    for i, row in enumerate(rows):
        alone = _sample(engine, [row], row.frames)
        n = row.frames - prompt.ref_len
        torch.testing.assert_close(together[i, :n], alone[0, :n], rtol=0, atol=2e-5)


def test_text_embedding_is_zero_at_the_filler(engine):
    ids = torch.tensor([[5, 6, 7, 0, 0, 0, 0, 0], [9, 9, 0, 0, 0, 0, 0, 0]])
    cond = torch.randn(2, 8, 100)
    with torch.inference_mode():
        fixed = f5.condition(engine.params["acoustic"], ids, cond, torch.tensor([6, 8]), engine.mcfg, torch.float32)
    text = fixed[..., 100:]
    assert fixed.shape == (4, 8, 132)
    assert float(text[0, 3:].abs().max()) == 0.0 and float(text[1, 2:].abs().max()) == 0.0
    assert float(text[2, 3:].abs().max()) == 0.0 and float(text[3, 2:].abs().max()) == 0.0  # null rows keep the mask
    assert float(text[0, :3].abs().min()) > 0.0 and float(text[2, :3].abs().min()) > 0.0
    assert torch.equal(fixed[:2, :, :100], cond) and float(fixed[2:, :, :100].abs().max()) == 0.0


def test_the_sway_grid_has_its_33_points():
    t = f5.time_grid(ModelConfig(acoustic_family="f5"))
    lin = np.linspace(0.0, 1.0, 33)
    assert t.shape == (33,) and t.dtype == np.float32
    np.testing.assert_allclose(t, lin - (np.cos(np.pi / 2 * lin) - 1 + lin), atol=1e-6)
    assert t[0] == 0.0 and abs(t[-1] - 1.0) < 1e-6 and np.all(np.diff(t) > 0)
    assert t[1] < 1 / 32 / 10  # sway packs the steps near t = 0


# ---------------------------------------------------------------- host rules


def test_the_duration_rule_in_bytes():
    cfg = _model()
    p = f5.Prompt(np.zeros((101, 100), np.float32), with_stop("hello world"), 100)
    assert p.text == "hello world. "
    assert with_stop("ends here.") == "ends here. " and with_stop("kept. ") == "kept. " and with_stop("句。") == "句。"
    row = f5.plan("abcdefghijklm", p, cfg)  # 13 bytes against 13
    assert row.frames == 100 + int(100 / 13 * 13) == 200
    assert row.ids == char_ids("hello world. abcdefghijklm")
    accented = f5.plan("café déjà", p, cfg)  # 9 characters, 12 bytes
    assert accented.frames == 100 + int(100 / 13 * 12)
    assert accented.ids[-9:] == [0 if c in "éà" else ord(c) - 32 for c in "café déjà"]
    assert f5.plan("a", p, cfg).frames == 100 + int(100 / 13)
    assert f5.plan("", p, cfg).frames == 102  # at least a frame past the prompt's frames and the text
    long = f5.plan("word " * 2000, p, cfg)
    assert long.frames == f5.MAX_POS
    assert reference.frames_of(100, 101, p.text, read_text("café déjà"), len(accented.ids), 1.0) == accented.frames


def test_the_noise_is_a_function_of_the_row():
    a = f5.noise([1, 2, 3], 50, 100)
    assert a.shape == (50, 100) and a.dtype == np.float32
    assert np.array_equal(a, f5.noise([1, 2, 3], 50, 100))
    assert np.array_equal(a, reference.noise([1, 2, 3], 50, 100).numpy())
    assert not np.array_equal(a, f5.noise([1, 2, 4], 50, 100))
    assert not np.array_equal(a[:40], f5.noise([1, 2, 3], 40, 100))
    assert abs(float(a.std()) - 1.0) < 0.05


def test_characters_and_the_normalizer():
    assert char_ids(" !~") == [0, 1, 94] and char_ids("é\n") == [0, 0]
    assert read_text("Dr. Smith paid $3.") == "doctor Smith paid three dollars."
    assert reference.char_ids("Hi é~") == char_ids("Hi é~")


# ---------------------------------------------------------------- the engine and the service


class _Replay:
    """A stand-in for a captured CUDA graph: `replay` reruns the body into the
    tensors the capture returned."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


class ReplayGraphs(graphs.GraphSet):
    def __init__(self, device):
        self.device, self.graphs = device, {}
        self.capturing = self.open = False
        self.replayed = self.eager = 0
        self._queued = collections.deque()

    def _mark(self):  # a replay on the CPU has ended when it returns
        return types.SimpleNamespace(synchronize=lambda: None)

    def side_stream(self):
        return torch.no_grad()

    def capture(self, name, fn):
        self.open = True
        try:
            out = fn()
        finally:
            self.open = False
        out.fill_(float("nan"))  # a capture computes nothing
        return _Replay(fn, out), out


def test_graphed_passes_equal_eager_passes_and_count_their_frames(checkpoint, voice):
    eager = TTSEngine(_config(checkpoint), device="cpu")
    eager.load(warmup=False)
    graphed = TTSEngine(_config(checkpoint), device="cpu")
    graphed.load(warmup=False)
    graphed._graphs = ReplayGraphs(graphed.device)
    graphed.warmup()
    # per shape: the conditioning, the Euler step, the last gather, the vocoder
    assert graphed.stats["graphs_captured"] == 4 * 3
    prompt = _prompt(eager, voice)
    texts = SENTENCES[:2]
    want = eager.synthesize_batch(texts, [prompt] * 2)
    got = graphed.synthesize_batch(texts, [prompt] * 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    st = graphed.get_stats()
    assert st["graph_passes"] == 1 and st["eager_passes"] == 0
    rows = [f5.plan(t, prompt, graphed.mcfg) for t in texts]
    assert st["f5_real_frames"] == sum(r.frames for r in rows)
    assert st["f5_padded_frames"] == 2 * graphed.f5_bucket(max(r.frames for r in rows))
    assert st["f5_prompt_frames"] == 2 * prompt.ref_len and st["f5_evaluations"] == 2 * 2 * 4
    assert [len(a) for a in got] == [(r.frames - prompt.ref_len) * 256 for r in rows]
    unwarmed = graphed.synthesize_batch(SENTENCES, [prompt] * 3)  # batch bucket 4 at frame bucket 1024
    assert graphed.stats["eager_passes"] == 1 and len(unwarmed) == 3


def test_the_service_serves_transcribed_voices_as_the_reference_speaks(checkpoint, voice, ref, tmp_path):
    b64 = base64.b64encode(voice[0]).decode()
    doc = " ".join(SENTENCES)

    async def run():
        cfg = _config(checkpoint)
        cfg.voice_cloning.cache_dir = str(tmp_path / "voices")
        svc = TTSService(cfg)
        await svc.start()
        try:
            with pytest.raises(ValueError, match="reference_text is required"):
                await svc.register_voice("v0", b64)
            await svc.register_voice("v0", b64, reference_text=voice[1])
            assert svc.voice_manager.get_reference_text("v0") == voice[1]
            audio = await svc.synthesize_full(doc, voice_id="v0")
            with pytest.raises(ValueError, match="transcribed prompt"):
                await svc.synthesize_full(doc)  # no default voice without its transcript
            sent = []

            class WS:
                async def send_json(self, data):
                    sent.append(data)

            await svc._handle_message(WS(), "c", {"type": "register_voice", "voice_id": "v1", "reference_audio": b64})
            assert sent[-1]["type"] == "error" and "reference_text" in sent[-1]["message"]
            await svc._handle_message(WS(), "c", {"type": "register_voice", "voice_id": "v1", "reference_audio": b64,
                                                  "reference_text": voice[1]})
            assert sent[-1] == {"type": "voice_registered", "voice_id": "v1"}
            prom = svc.metrics_prometheus()
            return audio, prom, svc.synthesizer.engine.get_stats()
        finally:
            await svc.shutdown()

    audio, prom, stats = asyncio.run(run())
    prompt = _ref_prompt(ref, voice)
    want = np.concatenate([ref.speak(s, prompt) for s in SENTENCES])
    assert audio.shape == want.shape and float(np.abs(want).max()) > 0.05  # heard in PCM16
    assert np.abs(audio - want).max() <= 2 / 32768  # a step of PCM16 rounding either way
    assert stats["f5_evaluations"] == 2 * 4 * len(SENTENCES)  # 4 steps x 2 guidance rows a sentence
    assert f"gonova_tts_engine_f5_evaluations {stats['f5_evaluations']}" in prom


def test_the_default_voice_needs_its_transcript(checkpoint, voice, tmp_path):
    path = tmp_path / "default.wav"
    path.write_bytes(voice[0])

    async def run():
        cfg = _config(checkpoint)
        cfg.voice_cloning.cache_dir = str(tmp_path / "voices")
        cfg.voice_cloning.default_voice_path = str(path)
        cfg.voice_cloning.default_voice_text = voice[1]
        svc = TTSService(cfg)
        await svc.start()
        try:
            return await svc.synthesize_full(SENTENCES[2]), svc._default_speaker
        finally:
            await svc.shutdown()

    audio, prompt = asyncio.run(run())
    assert isinstance(prompt, f5.Prompt) and prompt.text == with_stop(read_text(voice[1]))
    assert len(audio) > 0


def test_streaming_yields_the_batch_audio_in_chunks(engine, voice):
    prompt = _prompt(engine, voice)
    doc = " ".join(SENTENCES)
    chunks = list(engine.synthesize_stream(doc, speaker=prompt, exaggeration=0.9))
    want = [engine.synthesize_batch([s], [prompt])[0] for s in SENTENCES]
    assert len(chunks) == sum(math.ceil(len(w) / (40 * 256)) for w in want)
    assert max(len(c) for c in chunks) == 40 * 256
    np.testing.assert_array_equal(np.concatenate(chunks), np.concatenate(want))
    with pytest.raises(ValueError, match="transcribed prompt"):
        list(engine.synthesize_stream("No voice.", speaker=None))


def test_embedding_a_voice_is_refused(engine, voice):
    x, sr = ref_audio.read_wav(voice[0])
    with pytest.raises(ValueError, match="transcribed prompt"):
        engine.embed_voice(x, sr)


# ---------------------------------------------------------------- parameters and configuration


def test_npz_round_trip_and_the_registry(checkpoint, tmp_path):
    cfg = _model()
    model, _ = params.load_checkpoint(checkpoint, cfg, "cpu")
    assert not hasattr(model, "speaker") and isinstance(model.acoustic, f5.DiT)
    flat = {k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()}
    path = str(tmp_path / "again.npz")
    np.savez(path, **flat)
    again, cfg2 = params.load_checkpoint(path, cfg, "cpu")
    assert cfg2.vocos_head == "polar"
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    with np.load(checkpoint) as z:
        assert set(z.files) == set(flat)
    fam = registry.get("f5tts")
    assert fam.kind == "acoustic" and fam.forward is f5.sample
    fresh = fam.init(torch.Generator().manual_seed(0), cfg)
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {k: v.shape for k, v in model.acoustic.state_dict().items()}


def test_published_widths_count_336m_dit_parameters():
    """The defaults are F5TTS_v1_Base's widths: 22 blocks of adaLN (6 d^2), q/k/v/o
    (4 d^2) and the MLP (4 d^2), the text embedding and its 4 ConvNeXt-V2 blocks,
    the input projection, two grouped position convs, the time MLP and the output."""
    m = ModelConfig(acoustic_family="f5", n_mels=100).model_dump()
    d, td = 1024, 512
    blocks = 22 * (6 * d * d + 6 * d + 4 * (d * d + d) + 2 * d * d + 2 * d + 2 * d * d + d)
    text = 2546 * td + 4 * (7 * td + td + 2 * td + 2 * td * td + 2 * td + 4 * td + 2 * td * td + td)
    rest = 712 * d + d + 2 * (31 * 64 * d + d) + 256 * d + d + d * d + d + 2 * d * d + 2 * d + 100 * d + 100
    assert weights.dit_params(m) == blocks + text + rest
    assert 336e6 < blocks + text + rest < 338e6


def test_the_nova_configuration_and_shapes_are_unchanged():
    cfg = Config()
    assert cfg.model.acoustic_family == "nova" and cfg.voice_cloning.default_voice_text is None
    m = tts.TTS(ModelConfig(d_model=32, n_heads=2, d_ff=64, speaker_dim=32, vocos_dim=32, vocos_ff=64, vocos_layers=1))
    assert {"acoustic", "vocoder", "speaker"} == {n for n, _ in m.named_children()}
    assert not any(k.startswith("acoustic.blocks") for k in m.state_dict())


@pytest.mark.parametrize("name", ["nova-vocos-demo", "nova-hifigan-v1", "nova-bigvgan-v2"])
def test_the_benchmarks_nova_configurations_build_as_before(name, tmp_path):
    """Each configuration the benchmark had serves the nova family with every F5
    field at its default: the Config it builds differs from the old one by those
    fields alone."""
    from tts_bench import serve, spec

    cell_of = {"nova-vocos-demo": "vocos-live", "nova-hifigan-v1": "hifigan-narrate", "nova-bigvgan-v2": "bigvgan-narrate"}
    cell = spec.load_cell(cell_of[name])
    cell.config = dict(cell.config, generate=None)
    cfg = serve.port_config(cell, 1, "cpu", str(tmp_path))
    fresh = ModelConfig()
    assert cfg.model.acoustic_family == "nova" and cfg.voice_cloning.default_voice_text is None
    for key in ModelConfig.model_fields:
        if key.startswith("f5_"):
            assert getattr(cfg.model, key) == getattr(fresh, key), key
    assert cfg.engine.f5_frame_buckets == EngineConfig().f5_frame_buckets
