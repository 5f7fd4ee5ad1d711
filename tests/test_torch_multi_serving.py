"""Data-parallel serving in the port (engine/multi.py) vs the JAX package's, on the CPU.

The JAX engine runs on conftest's 8 virtual CPU devices; the port's stands in for
8 devices by `multi.local_devices` returning 8 CPU entries (monkeypatched), so
its 8 replicas each run a contiguous block of the batch's rows in this process.
Both serve one seeded checkpoint at tests/test_multi_serving.py's tiny config,
written by the JAX package's `save_params_npz` and read through
`model.model_path`. Bounds: tests/test_multi_serving.py's 3e-3 between dp and
the reference.
"""

import numpy as np
import pytest
import torch

from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine, multi
from gonova_tts_tpu_torch.engine.multi import DataParallel
from parity_gpu import one_shot

MODEL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1,
    speaker_dim=32, upsample_initial_channel=32, vocos_dim=128, vocos_ff=256,
    vocos_layers=2, compute_dtype="float32",
)
ENGINE = dict(
    token_buckets=[32, 64, 128], batch_buckets=[1, 4, 8], warmup_shapes=[],
    stream_chunk_frames=24, stream_context_frames=12,
)
TEXTS = [f"Parallel request number {i}." for i in range(7)] + ["A longer eighth request, so the rows differ."]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    import jax

    from gonova_tts_tpu.config import ModelConfig as JModelConfig
    from gonova_tts_tpu.models import tts as jtts
    from gonova_tts_tpu.train.checkpoint import save_params_npz

    path = str(tmp_path_factory.mktemp("dp") / "tiny.npz")
    return save_params_npz(path, jtts.init(jax.random.PRNGKey(0), JModelConfig(**MODEL)), dtype="float32")


@pytest.fixture
def eight_devices(monkeypatch):
    monkeypatch.setattr(multi, "local_devices", lambda device: [torch.device("cpu")] * 8)


def port_engine(checkpoint, n):
    cfg = Config()
    cfg.model = ModelConfig(**MODEL, model_path=checkpoint, device="cpu")
    cfg.engine = EngineConfig(**ENGINE, data_parallel=n)
    eng = TTSEngine(cfg, device="cpu")
    eng.load(warmup=False)
    return eng


def test_data_parallel_helper():
    dp = DataParallel(4, devices=[torch.device("cpu")] * 8)
    assert dp.n == 4 and len(dp.devices) == 4
    assert [dp.round_batch(b) for b in (1, 4, 5)] == [4, 4, 8]
    rows = dp.shard_rows(np.arange(8)[:, None])
    assert [r[:, 0].tolist() for r in rows] == [[0, 1], [2, 3], [4, 5], [6, 7]]  # P('data')'s blocks
    with pytest.raises(ValueError, match="requested 99 devices, have 8"):
        DataParallel(99, devices=[torch.device("cpu")] * 8)
    with pytest.raises(ValueError, match="requested 99 devices"):
        DataParallel(99)


def test_place_params_gives_each_device_its_own_replica():
    layer = torch.nn.Linear(3, 2)
    reps = DataParallel(2, devices=[torch.device("cpu")] * 2).place_params(layer)
    assert reps[0] is not layer and reps[0] is not reps[1]
    assert reps[0].weight is not reps[1].weight
    torch.testing.assert_close(reps[1].weight, layer.weight, rtol=0, atol=0)


@pytest.mark.parametrize("two_stage", [False, True], ids=["one_graph", "two_stage"])
def test_dp_engine_matches_jax_dp_engine(checkpoint, eight_devices, monkeypatch, two_stage):
    """8 two-stage replicas (the frame bucket from the whole batch's frame counts)
    against the JAX engine's 8-device mesh, one-graph or two-stage: the same
    lengths, audio within 3e-3; and the port's dp audio within one int16 step of
    the one-shot pipeline on one replica (one_graph) or of its own one-replica
    engine (two_stage)."""
    from gonova_tts_tpu.config import Config as JConfig
    from gonova_tts_tpu.config import EngineConfig as JEngineConfig
    from gonova_tts_tpu.config import ModelConfig as JModelConfig
    from gonova_tts_tpu.engine import TTSEngine as JTTSEngine

    jcfg = JConfig()
    jcfg.model = JModelConfig(**MODEL, model_path=checkpoint)
    jcfg.engine = JEngineConfig(**ENGINE, data_parallel=8)
    monkeypatch.setattr(JTTSEngine, "two_stage_enabled", property(lambda self: two_stage))
    ref = JTTSEngine(jcfg, seed=0)
    ref.load(warmup=False)
    want = ref.synthesize_batch(TEXTS)

    eng = port_engine(checkpoint, 8)
    assert len(eng.replicas) == 8 and eng.params is eng.replicas[0]
    got = eng.synthesize_batch(TEXTS)
    one_replica = port_engine(checkpoint, 1)
    one = one_replica.synthesize_batch(TEXTS) if two_stage else one_shot(one_replica, TEXTS)
    assert len(got) == len(want) == len(one) == 8
    for a, b, c in zip(got, want, one):
        assert len(a) == len(b) == len(c)
        np.testing.assert_allclose(a, b, atol=3e-3)
        np.testing.assert_allclose(a, c, atol=1.01 / 32767)
    if two_stage:
        assert eng.stats["vocode_frames_executed"] == ref.stats["vocode_frames_executed"]


def test_dp_engine_rounds_small_batches(checkpoint, eight_devices):
    """One request is padded to 8 rows (one a replica) and comes back alone, equal
    to the one-replica engine's audio within one int16 step; warmup runs the
    rounded shape on every replica."""
    eng = port_engine(checkpoint, 8)
    eng.ecfg.warmup_shapes = [[1, 32]]
    eng.warmup()
    # The (8, 32) batch shape's encode, its decode_vocode at each frame bucket, the stream window.
    assert eng.stats["compiles"] == 2 + len(eng._frame_buckets(32)) == 5
    out = eng.synthesize_batch(["One lonely request."])
    assert len(out) == 1 and np.isfinite(out[0]).all()
    ref = port_engine(checkpoint, 1).synthesize_batch(["One lonely request."])
    np.testing.assert_allclose(out[0], ref[0], atol=1.01 / 32767)
    assert eng.stats["padded_tokens"] == 8 * 32


def test_dp_streaming_and_embedding_run_on_replica_zero(checkpoint, eight_devices):
    """Streaming and voice embedding run on replica 0 and equal the one-replica
    engine's (bit-equal: the same weights on the same device)."""
    eng = port_engine(checkpoint, 8)
    one = port_engine(checkpoint, 1)
    text = "Streaming on a mesh. Second sentence."
    chunks = list(eng.synthesize_stream(text))
    assert len(chunks) >= 2 and all(np.isfinite(c).all() for c in chunks)
    np.testing.assert_array_equal(np.concatenate(chunks), np.concatenate(list(one.synthesize_stream(text))))
    wav = 0.1 * np.sin(np.arange(24000) * 2 * np.pi * 220 / 24000).astype(np.float32)
    np.testing.assert_array_equal(eng.embed_voice(wav, 24000), one.embed_voice(wav, 24000))
