"""The plain reference agrees with the served program at a tiny float32 config:
the text frontend's ids, the speaker embedding of a recording, and each family's
audio as the engine serves it, within one PCM16 step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tts_bench import voices
from tts_bench.reference import audio as ref_audio
from tts_bench.reference.model import Numerics, Reference, load_tree
from tts_bench.reference.text import pick_bucket, text_to_ids
from tts_bench.tests import _tiny

TEXTS = [
    "The quick brown fox jumps over the lazy dog near the river bank today.",
    "Zorvanek met Dr. Smith at 10:30 on March 3rd, 2021, in Maskerlund.",
    "She said nothing.",
    "Every morning the baker opened his shop before the sun rose over the hills, and the whole street "
    "smelled of bread, cinnamon and smoke until the schoolchildren came running past.",
]


@pytest.fixture(scope="module", params=["vocos", "hifigan"])
def pair(request, tmp_path_factory):
    from gonova_tts_tpu_torch.config import Config
    from gonova_tts_tpu_torch.engine import TTSEngine

    torch.set_num_threads(4)
    path = _tiny.checkpoint(str(tmp_path_factory.mktemp("ck") / "tiny.npz"), request.param)
    cfg = Config()
    for k, v in dict(_tiny.TINY, vocoder_family=request.param).items():
        setattr(cfg.model, k, v)
    cfg.model.model_path = path
    cfg.engine.warmup_shapes = []
    engine = TTSEngine(cfg, device="cpu")
    engine.load(warmup=False)
    tree, _ = load_tree(path, "cpu")
    return engine, Reference(tree, cfg.model.model_dump(), "cpu"), cfg


def test_ids_match_the_served_frontend():
    from gonova_tts_tpu_torch.text import text_to_ids as served

    for t in TEXTS:
        assert text_to_ids(t) == served(t)


@pytest.mark.parametrize("sr", [24000, 44100])
def test_embedding(pair, sr):
    engine, ref, _ = pair
    v = voices.Voice(2**35 + 1, 0, sr)
    x, rate = ref_audio.read_wav(v.wav)
    served = engine.embed_voice(x, rate)
    with torch.no_grad():
        mine = ref.embed(x, rate)
    assert np.abs(served - mine).max() < 1e-5


def test_audio_within_one_step(pair):
    engine, ref, cfg = pair
    spk = np.random.default_rng(0).standard_normal(cfg.model.speaker_dim).astype(np.float32)
    spk /= np.linalg.norm(spk)
    for t in TEXTS:
        served = engine.synthesize_batch([t], speakers=[spk], exaggerations=[0.5])[0]
        ids = text_to_ids(t)
        bucket = pick_bucket(len(ids), cfg.engine.token_buckets)
        mine = ref.speak(ids[:bucket], bucket, spk, 0.5)
        assert len(served) == len(mine)
        assert np.abs(served - mine).max() <= 1.0 / 32768 + 1e-9


def test_fp8_numerics_round_operands():
    x = torch.linspace(-3, 3, 101)
    q = Numerics("fp8").q(x)
    assert not torch.equal(q, x) and torch.allclose(q, x, rtol=0.07, atol=1e-3)
    assert torch.equal(Numerics("fp32").q(x), x)
