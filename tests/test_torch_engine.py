"""The port's TTSEngine vs the JAX TTSEngine at tests/test_engine.py's tiny config, f32.

The port engine serves the JAX engine's own seeded weights (loaded with
`params.from_numpy_tree`). Every port pass is two-stage; it is held against the JAX
engine at either of that engine's dispatch modes and against the one-shot pipeline
(`parity_gpu.one_shot`: `tts.synthesize` at the worst-case frame count, packed as
the engine packs). Bounds, in int16 PCM steps as the JAX engine pins them: port vs
JAX and two-stage vs one-shot within 1.01/32767 (one LSB: float rounding may flip
one quantization step); streamed vs one-shot within 2.5/32768.
"""

import time

import jax
import numpy as np
import pytest
import torch

from gonova_tts_tpu.config import Config as JConfig
from gonova_tts_tpu.config import EngineConfig as JEngineConfig
from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.engine import TTSEngine as JTTSEngine
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine
from gonova_tts_tpu_torch.models import params
from parity_gpu import one_shot


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores: torch's own thread pool (8 spinning
    threads per worker) would starve the other workers' tests."""
    torch.set_num_threads(1)


LSB16 = 1.0 / 32767.0
MODEL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    upsample_initial_channel=32, vocos_dim=128, vocos_ff=256, vocos_layers=2,
    compute_dtype="float32",
)
ENGINE = dict(
    token_buckets=[32, 64, 128, 192], batch_buckets=[1, 4, 8], max_batch=8,
    batch_window_ms=5.0, stream_chunk_frames=24, stream_context_frames=12,
    warmup_shapes=[[1, 32]],
)
TEXTS = ["Hello there world.", "A second and much longer sentence for the batch, with 42 words."]


def configs(model=None, engine=None):
    m, e = {**MODEL, **(model or {})}, {**ENGINE, **(engine or {})}
    port = Config()
    port.model, port.engine = ModelConfig(**m), EngineConfig(**e)
    ref = JConfig()
    ref.model, ref.engine = JModelConfig(**m), JEngineConfig(**e)
    return port, ref


def engines(model=None, engine=None):
    port_cfg, ref_cfg = configs(model, engine)
    ref = JTTSEngine(ref_cfg, seed=0)
    ref.load(warmup=False)
    port = TTSEngine(port_cfg, device="cpu")
    port.load(warmup=False)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    port.params = params.from_numpy_tree(tree, port.mcfg, device="cpu")
    return port, ref


@pytest.fixture(scope="module")
def pair():
    return engines()


def pinned(engine, mode, texts, **kw):
    """The JAX engine's batch at one dispatch mode (False: one-graph, True: two-stage)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(engine), "two_stage_enabled", property(lambda self: mode))
        return engine.synthesize_batch(texts, **kw)


@pytest.mark.parametrize("mode", [False, True])
def test_synthesize_batch_matches_jax_engine(pair, mode):
    """The port's two-stage batch against the JAX engine's one-graph (False) and
    two-stage (True) batch."""
    port, ref = pair
    ours, theirs = port.synthesize_batch(TEXTS), pinned(ref, mode, TEXTS)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1.01 * LSB16, rtol=0)


def test_two_stage_matches_one_graph(pair):
    """The engine's frame-bucketed pass against the one-shot pipeline at the
    token bucket's worst-case frame count."""
    port, _ = pair
    one = one_shot(port, TEXTS)
    before = dict(port.stats)
    two = port.synthesize_batch(TEXTS)
    assert port.stats["vocode_frames_executed"] - before["vocode_frames_executed"] > 0
    assert (
        port.stats["vocode_frames_executed"] - before["vocode_frames_executed"]
        < port.stats["vocode_frames_worstcase"] - before["vocode_frames_worstcase"]
    )
    for a, b in zip(one, two):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1.01 * LSB16, rtol=0)


def test_speaker_and_exaggeration_match_jax_engine(pair):
    port, ref = pair
    spk = np.random.default_rng(3).standard_normal(32).astype(np.float32) * 0.3
    kw = dict(speakers=[spk, None], exaggerations=[0.0, 1.5])
    ours = port.synthesize_batch(TEXTS, **kw)
    for want in (pinned(ref, False, TEXTS, **kw), pinned(ref, True, TEXTS, **kw), one_shot(port, TEXTS, **kw)):
        for a, b in zip(ours, want):
            np.testing.assert_allclose(a, b, atol=1.01 * LSB16, rtol=0)


@pytest.mark.parametrize("ctx", [12, 40])  # 40 > stride 24: clamped to the stride
def test_streamed_matches_one_shot(pair, ctx):
    port, ref = pair
    text = "A sentence long enough to require several streaming vocoder windows to cover completely."
    port.ecfg.stream_context_frames = ref.ecfg.stream_context_frames = ctx
    try:
        streamed = np.concatenate(list(port.synthesize_stream(text)))
        jstreamed = np.concatenate(list(ref.synthesize_stream(text)))
    finally:
        port.ecfg.stream_context_frames = ref.ecfg.stream_context_frames = 12
    whole = one_shot(port, [text])[0]
    np.testing.assert_allclose(streamed, whole, atol=2.5 / 32768)
    np.testing.assert_allclose(streamed, jstreamed, atol=1.01 * LSB16, rtol=0)
    assert list(port.synthesize_stream("")) == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_equals_batch_on_the_demo_checkpoint(dtype):
    """tools/eval_checkpoint.py's stream check on the demo checkpoint: the port's
    streamed and batch audio are equal to the int16 LSB (0 LSB), as the JAX
    engine's are on the CPU."""
    from gonova_tts_tpu_torch.train.synth_corpus import make_sentences

    cfg = Config()
    cfg.model = ModelConfig(model_path="assets/checkpoints/demo_ema_f16.npz", compute_dtype=dtype)
    eng = TTSEngine(cfg, device="cpu")
    eng.load(warmup=False)
    text, spk = make_sentences(1)[0], eng.default_speaker()
    whole = eng.synthesize_batch([text], speakers=[spk])[0]
    streamed = np.concatenate(list(eng.synthesize_stream(text, speaker=spk)))
    assert len(streamed) == len(whole)
    assert float(np.max(np.abs(whole - streamed))) * 32767.0 == 0.0


def test_two_stage_local_attention_choice_follows_one_graph():
    """One-shot frame count past the local threshold, frame bucket below it: the
    two-stage decode must still take local attention, as the one-shot pipeline
    does (and match the JAX engine)."""
    port, ref = engines(
        model={"local_attention_min_frames": 256, "decoder_attention_window": 32},
        engine={"warmup_shapes": [], "token_buckets": [64]},
    )
    text = ["The quick brown fox jumps over the lazy dog near the river bank."]
    one = one_shot(port, text)
    two = port.synthesize_batch(text)
    np.testing.assert_allclose(one[0], two[0], atol=1.01 * LSB16, rtol=0)
    np.testing.assert_allclose(two[0], pinned(ref, True, text)[0], atol=1.01 * LSB16, rtol=0)


def test_kernel_routes_match_jax_engine():
    """Both kernel switches on: the port's plain kernel versions vs JAX's Pallas
    kernels in interpret mode, through the whole engine."""
    port, ref = engines(model={"acoustic_pallas": True, "vocos_pallas": True}, engine={"warmup_shapes": []})
    for a, b in zip(port.synthesize_batch(TEXTS), pinned(ref, True, TEXTS)):
        np.testing.assert_allclose(a, b, atol=1.01 * LSB16, rtol=0)


def test_load_warmup_stats_health(pair):
    port_cfg, _ = configs()
    eng = TTSEngine(port_cfg, device="cpu", seed=3)
    assert eng.health_check()["status"] == "unloaded"
    eng.load(warmup=True)
    # The warm-up shape's encode, its decode_vocode at every frame bucket, the stream window.
    assert eng.is_loaded and eng.stats["compiles"] == 2 + len(eng._frame_buckets(32)) == 5
    assert eng.two_stage_enabled
    assert eng.synthesize_batch([]) == []
    outs = eng.synthesize_batch([f"Sentence number {i}." for i in range(9)])  # > largest bucket
    assert len(outs) == 9 and all(np.isfinite(w).all() and len(w) % eng.hop == 0 for w in outs)
    stats = eng.get_stats()
    assert 0.0 < stats["padding_efficiency"] <= 1.0
    assert stats["timers"]["engine.pass"]["count"] == 1
    assert eng.health_check()["status"] == "ok"
    eng.synthesize_batch(["x"], id_lists=[[5] * 250])
    assert eng.stats["truncated_sentences"] == 1
    # A device section held far past any real pass reports degraded, not busy.
    assert eng._lock.acquire(blocking=False)
    try:
        eng._busy_since = time.time() - 400.0
        assert eng.health_check(stall_after_s=300.0)["status"] == "degraded"
        eng._busy_since = time.time()
        assert eng.health_check(stall_after_s=300.0)["status"] == "ok"
    finally:
        eng._busy_since = 0.0
        eng._lock.release()


def test_load_reads_nothing_back_from_the_device(monkeypatch):
    """Without warm-up, `load` copies nothing from the device to the host: it
    times no readback to choose a dispatch mode."""
    port_cfg, _ = configs()
    copies = []

    def counted(name):
        real = getattr(torch.Tensor, name)

        def call(self, *args, **kwargs):
            copies.append(name)
            return real(self, *args, **kwargs)
        return call

    for name in ("cpu", "numpy", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, counted(name))
    eng = TTSEngine(port_cfg, device="cpu")
    eng.load(warmup=False)
    assert eng.is_loaded and copies == []
    monkeypatch.undo()
    assert len(eng.synthesize_batch(TEXTS[:1])) == 1


def test_entry_points_default_to_cuda():
    """Without a card, an engine that did not ask for the CPU raises."""
    port_cfg, _ = configs()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TTSEngine(port_cfg)
