"""The port's voice-cloning path vs the JAX package, f32 on the CPU: the stride-2
SAME convolution, the speaker encoder, `TTSEngine.embed_voice`, and cloned speech
from a registered voice through the service facade.

Both engines serve one seeded JAX parameter tree (loaded into the port with
`params.from_numpy_tree`). Tolerances: conv and encoder atol 1e-5 (f32, another
summation order); the embedding of a WAV within 1e-4 (resampler, log-mel and
encoder in sequence; the embedding has unit norm).
"""

import asyncio
import base64
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.config import Config as JConfig
from gonova_tts_tpu.config import EngineConfig as JEngineConfig
from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.engine import TTSEngine as JTTSEngine
from gonova_tts_tpu.models import layers as jl
from gonova_tts_tpu.models import speaker as jspeaker
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine, VoiceEmbeddingCache
from gonova_tts_tpu_torch.models import layers as tl
from gonova_tts_tpu_torch.models import params
from gonova_tts_tpu_torch.models import speaker as tspeaker
from gonova_tts_tpu_torch.service import StreamingSynthesizer, VoiceManager
from gonova_tts_tpu_torch.utils import read_wav


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores: torch's own thread pool (8 spinning
    threads per worker) would starve the other workers' tests."""
    torch.set_num_threads(1)


DEFAULT_VOICE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "default_voice.wav")
MODEL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocos_dim=128, vocos_ff=256, vocos_layers=2, compute_dtype="float32",
)
ENGINE = dict(warmup_shapes=[[1, 32]], stream_chunk_frames=24, stream_context_frames=12)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


# ------------------------------------------------------------------ conv1d


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("t", [10, 11])
def test_conv1d_same_padding_matches_jax(rng, stride, k, t):
    """JAX pads SAME asymmetrically for stride 2: k=5 → (1, 2) for even T, (2, 2) for odd."""
    p = jl.conv1d_init(jax.random.PRNGKey(k), 6, 8, k)
    p = dict(p, b=jnp.asarray(rng.standard_normal(8).astype(np.float32)))
    x = rng.standard_normal((2, t, 6)).astype(np.float32)
    ours = tl.conv1d(to_torch(p), torch.as_tensor(x), stride=stride)
    theirs = np.asarray(jl.conv1d(p, jnp.asarray(x), stride=stride))
    assert ours.shape == theirs.shape == (2, -(-t // stride), 8)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ speaker encoder


@pytest.mark.parametrize("t", [937, 40, 7])  # the serving length (odd at every stage), even, tiny
def test_speaker_forward_matches_jax(rng, t):
    cfg = JModelConfig(speaker_dim=32)
    p = jspeaker.init(jax.random.PRNGKey(3), cfg, hidden=64)
    mel = rng.standard_normal((3, t, cfg.n_mels)).astype(np.float32)
    lengths = np.array([t, max(t // 2, 1), max(t - 3, 1)])
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    ours = tspeaker.forward(to_torch(p), torch.as_tensor(mel), torch.as_tensor(mask))
    theirs = np.asarray(jspeaker.forward(p, jnp.asarray(mel), jnp.asarray(mask)))
    assert ours.shape == theirs.shape == (3, 32) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-5)


def test_speaker_forward_ignores_masked_frames(rng):
    p = to_torch(jspeaker.init(jax.random.PRNGKey(3), JModelConfig(speaker_dim=32), hidden=64))
    mel = rng.standard_normal((1, 60, 80)).astype(np.float32)
    mask = (np.arange(60)[None] < 33).astype(np.float32)
    other = mel.copy()
    other[:, 33:] = 7.0
    a = tspeaker.forward(p, torch.as_tensor(mel), torch.as_tensor(mask))
    b = tspeaker.forward(p, torch.as_tensor(other), torch.as_tensor(mask))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_speaker_forward_in_bf16_stays_close(rng):
    p = to_torch(jspeaker.init(jax.random.PRNGKey(3), JModelConfig(speaker_dim=32), hidden=64))
    mel = torch.as_tensor(rng.standard_normal((2, 50, 80)).astype(np.float32))
    mask = torch.ones((2, 50))
    a, b = tspeaker.forward(p, mel, mask), tspeaker.forward(p, mel, mask, dtype=torch.bfloat16)
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) < 0.05


# ------------------------------------------------------------------ engine.embed_voice


@pytest.fixture(scope="module")
def pair():
    ref_cfg = JConfig()
    ref_cfg.model, ref_cfg.engine = JModelConfig(**MODEL), JEngineConfig(**ENGINE)
    ref = JTTSEngine(ref_cfg, seed=0)
    ref.load(warmup=False)
    cfg = Config()
    cfg.model, cfg.engine = ModelConfig(**MODEL), EngineConfig(**ENGINE)
    port = TTSEngine(cfg, device="cpu")
    port.load(warmup=False)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    port.params = params.from_numpy_tree(tree, port.mcfg, device="cpu")
    return port, ref


def test_embed_voice_file_matches_jax_engine(pair):
    port, ref = pair
    ours, theirs = port.embed_voice_file(DEFAULT_VOICE), ref.embed_voice_file(DEFAULT_VOICE)
    assert ours.shape == theirs.shape == (32,) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ours), 1.0, atol=1e-5)


@pytest.mark.parametrize(
    "sr,seconds,stereo",
    [(24000, 1.3, False), (48000, 0.6, True), (44100, 0.25, False), (24000, 10.4, False)],
    ids=["24k", "48k-stereo", "44k1", "longer-than-the-buffer"],
)
def test_embed_voice_matches_jax_engine(pair, rng, sr, seconds, stereo):
    port, ref = pair
    n = int(sr * seconds)
    audio = (0.3 * np.sin(2 * np.pi * 180.0 * np.arange(n) / sr) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    if stereo:
        audio = np.stack([audio, 0.5 * audio], axis=1)
    ours, theirs = port.embed_voice(audio, sr), ref.embed_voice(audio, sr)
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)
    assert np.isfinite(ours).all()


def test_embed_voice_depends_on_the_voice_and_needs_a_loaded_engine(pair, rng):
    port, _ = pair
    a = port.embed_voice_file(DEFAULT_VOICE)
    b = port.embed_voice(rng.standard_normal(24000).astype(np.float32) * 0.1, 24000)
    assert float(np.abs(a - b).max()) > 1e-3
    cfg = Config()
    cfg.model, cfg.engine = ModelConfig(**MODEL), EngineConfig(**ENGINE)
    with pytest.raises(RuntimeError, match="not loaded"):
        TTSEngine(cfg, device="cpu").embed_voice(np.zeros(24000, np.float32), 24000)


def test_embed_voice_mel_switch_is_inert_on_the_cpu(pair):
    """`engine.mel_pallas` picks the fused kernel only on a CUDA engine."""
    port, _ = pair
    assert port.ecfg.mel_pallas
    a = port.embed_voice_file(DEFAULT_VOICE)
    port.ecfg.mel_pallas = False
    try:
        np.testing.assert_array_equal(port.embed_voice_file(DEFAULT_VOICE), a)
    finally:
        port.ecfg.mel_pallas = True


def test_cloned_speech_differs_from_the_default_speaker_and_matches_jax(pair):
    port, ref = pair
    emb = port.embed_voice_file(DEFAULT_VOICE)
    text = ["A cloned voice says this."]
    cloned, plain = port.synthesize_batch(text, speakers=[emb])[0], port.synthesize_batch(text)[0]
    assert np.isfinite(cloned).all() and cloned.size > 0
    assert cloned.shape != plain.shape or float(np.abs(cloned - plain).max()) > 1e-4
    theirs = ref.synthesize_batch(text, speakers=[emb])[0]
    assert cloned.shape == theirs.shape
    np.testing.assert_allclose(cloned, theirs, atol=1.01 / 32767, rtol=0)


# ------------------------------------------------------------------ registered voice → cloned stream


def test_registered_voice_streams_cloned_speech(tmp_path):
    """WAV (base64) → VoiceManager → path → embedding (cached) → streamed speech."""
    cfg = Config()
    cfg.model, cfg.engine = ModelConfig(**MODEL), EngineConfig(**ENGINE)
    synth = StreamingSynthesizer(cfg, device="cpu")
    voices = VoiceManager(cache_dir=str(tmp_path / "voices"))
    cache = VoiceEmbeddingCache()
    with open(DEFAULT_VOICE, "rb") as fh:
        payload = base64.b64encode(fh.read()).decode()

    async def run():
        await synth.load()
        stored = await voices.register_voice("My Voice!", payload)
        path = await voices.get_voice("My Voice!")
        assert path == stored and os.path.exists(path)
        emb = synth.engine.embed_voice_file(path)
        cache.put("My_Voice_", emb)
        audio, sr = read_wav(path)
        same = await synth.extract_voice_embedding(np.asarray(audio, np.float32), sr)
        by_emb = [c async for c in synth.synthesize_streaming("Cloned speech.", voice_embedding=cache.get("My_Voice_"))]
        by_path = [c async for c in synth.synthesize_streaming("Cloned speech.", voice_embedding=path)]
        default = [c async for c in synth.synthesize_streaming("Cloned speech.")]
        return emb, same, by_emb, by_path, default

    emb, same, by_emb, by_path, default = asyncio.run(run())
    np.testing.assert_array_equal(emb, same)
    np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-5)
    a, b, d = np.concatenate(by_emb), np.concatenate(by_path), np.concatenate(default)
    assert a.dtype == np.float32 and a.size > 0 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)  # path-given and array-given embeddings: the same audio
    assert a.shape != d.shape or float(np.abs(a - d).max()) > 1e-4
    assert not list((tmp_path / "voices").glob("*.tmp"))
