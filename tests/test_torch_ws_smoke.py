"""The port's service smoke and frontend coverage tools against the JAX package's, on the CPU.

* `tools.g2p_coverage` vs tools/g2p_coverage.py (run in process): the same stdout,
  line for line, on the built-in sample and on a text with words no tier but the
  neural or LTS one resolves (`--list-misses`); tests/test_morph.py's bounds on the
  port's frontend (`exact_coverage` >= 0.97, `morph` > 0.2).
* `tools.ws_smoke` vs tools/ws_smoke.py (run in process, its `Config` patched to the
  tiny model in f32) on one tiny npz and the same reference WAV: `chunks`,
  `final_chunk_id`, `audio_s` and `finite` equal, `rms` and `peak` within one int16
  LSB (3.1e-5), the time keys present. The port's tool over aiohttp and over the
  in-memory socket (aiohttp hidden) gives the same audio keys.
* `service/memory_socket.py`'s client side: frames in order, `request` then `receive`.
"""

import asyncio
import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import gonova_tts_tpu.config as jconfig
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.models.tts import TTS
from gonova_tts_tpu_torch.service.memory_socket import MemorySocket
from gonova_tts_tpu_torch.tools import g2p_coverage, ws_smoke
from gonova_tts_tpu_torch.train.checkpoint import save_params_npz
from gonova_tts_tpu_torch.train.synth_corpus import DEFAULT_SENTENCES, DEFAULT_SPEAKERS, generate_corpus
from gonova_tts_tpu_torch.utils import read_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]
LSB16 = 1.0 / 32767.0
TINY = dict(
    d_model=32, n_heads=2, d_ff=64, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocos_dim=32, vocos_ff=64, vocos_layers=1, compute_dtype="float32",
)
ENGINE = dict(
    token_buckets=[32, 64, 128, 192], batch_buckets=[1, 4], max_batch=4, batch_window_ms=5.0,
    stream_chunk_frames=24, stream_context_frames=8, warmup_shapes=[[1, 32]],
)
WS_KEYS = {"checkpoint", "load_s", "health", "backend", "ttfa_steady_ms", "wall_steady_s", "sentences", "chunks",
           "final_chunk_id", "ttfa_ms", "wall_s", "audio_s", "realtime_x", "rms", "peak", "finite", "wav"}
AUDIO_KEYS = ("sentences", "chunks", "final_chunk_id", "audio_s", "rms", "peak", "finite")
MISSES_TEXT = "The zorblax flimbered over the quandrixes.\nA vreen skorped 12 times.\n"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool_main(name, argv, monkeypatch):
    """Run the JAX package's tools/<name>.py `main` in process on `argv`; returns
    its stdout lines."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue().strip().splitlines()


# ---------------------------------------------------------------- g2p_coverage


@pytest.mark.parametrize("case", ["sample", "misses"])
def test_g2p_coverage_prints_the_jax_tools_lines(case, tmp_path, monkeypatch, capsys):
    argv = []
    if case == "misses":
        path = tmp_path / "text.txt"
        path.write_text(MISSES_TEXT, encoding="utf-8")
        argv = ["--list-misses", str(path)]
    result = g2p_coverage.main(argv)
    ours = capsys.readouterr().out.strip().splitlines()
    theirs = jax_tool_main("g2p_coverage", argv, monkeypatch)
    assert ours == theirs
    assert json.loads(ours[0]) == {k: v for k, v in result.items() if k != "misses"}
    if case == "misses":
        assert len(ours) == 2 and ours[1].startswith("misses: ")
        assert {"zorblax", "flimbered", "quandrixes", "vreen", "skorped"} <= set(result["misses"])
        assert result["neural_or_lts"] > 0
    else:
        assert len(ours) == 1 and result["misses"] == []


def test_g2p_coverage_bounds_on_the_ports_frontend():
    """tests/test_morph.py::test_coverage_harness_runs' bounds on the port's frontend:
    lexicon + morph resolve the sample, and the morph tier carries real weight."""
    stats = g2p_coverage.evaluate(g2p_coverage.parse_args([]))
    assert stats["exact_coverage"] >= 0.97
    assert stats["morph"] > 0.2
    assert stats["tokens"] == len(g2p_coverage.tokens_of(g2p_coverage.SAMPLE))


def test_classify_tiers_match_jax_tool():
    spec = importlib.util.spec_from_file_location("jax_tool_g2p_coverage", ROOT / "tools" / "g2p_coverage.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    words = ["bridge", "walkways", "travelled", "zorblax", "the", "quandrixes"]
    tiers = [g2p_coverage.classify(w) for w in words]
    assert tiers == [mod.classify(w) for w in words]
    # The vendored ensemble's weights are in the repo, so the last tier is the neural one.
    assert tiers == ["lexicon", "morph", "morph", "neural", "lexicon", "neural"]


# ---------------------------------------------------------------- ws_smoke


@pytest.fixture(scope="module")
def ws_runs(tmp_path_factory):
    """The JAX tool, the port's tool over aiohttp and the port's tool over the
    in-memory socket, each once with --sentences 2 --repeat 1 on one tiny npz and
    the corpus' ref_spk_mid.wav; returns their reports and the WAVs they wrote."""
    root = tmp_path_factory.mktemp("ws")
    npz = str(root / "tiny.npz")
    save_params_npz(npz, TTS(ModelConfig(**TINY, device="cpu"), torch.Generator().manual_seed(1)))
    corpus = str(root / "corpus")  # two training sentences: a reference clip over 3 s
    generate_corpus(corpus, sentences=DEFAULT_SENTENCES[:3], speakers=DEFAULT_SPEAKERS[:2], variable=True, holdout=1)
    cfg = Config()
    cfg.model = ModelConfig(**TINY, device="cpu")
    cfg.engine = EngineConfig(**ENGINE)

    def argv(name):
        return ["--checkpoint", npz, "--corpus", corpus, "--sentences", "2", "--repeat", "1",
                "--voices-dir", str(root / f"voices_{name}"), "--out", str(root / f"{name}.wav")]

    reports = {"aiohttp": ws_smoke.run(ws_smoke.parse_args(argv("aiohttp") + ["--device", "cpu"]), cfg)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "aiohttp.test_utils", None)  # `from aiohttp.test_utils import ...` fails
        reports["memory"] = ws_smoke.run(ws_smoke.parse_args(argv("memory") + ["--device", "cpu"]), cfg)
    with pytest.MonkeyPatch.context() as mp:
        config = jconfig.Config

        def tiny_config():
            c = config()
            c.model = jconfig.ModelConfig(**TINY)
            c.engine = jconfig.EngineConfig(**ENGINE)
            return c

        mp.setattr(jconfig, "Config", tiny_config)
        reports["jax"] = json.loads(jax_tool_main("ws_smoke", argv("jax"), mp)[-1])
    wavs = {k: read_wav(str(root / f"{k}.wav")) for k in reports}
    return reports, wavs


def test_ws_smoke_matches_jax_tool(ws_runs):
    reports, wavs = ws_runs
    ours, theirs = reports["aiohttp"], reports["jax"]
    assert set(theirs) == WS_KEYS and set(ours) == WS_KEYS | {"transport"}
    for k in ("chunks", "final_chunk_id", "audio_s", "finite", "sentences"):
        assert ours[k] == theirs[k], k
    for k in ("rms", "peak"):
        assert abs(ours[k] - theirs[k]) <= LSB16, (k, ours[k], theirs[k])
    assert ours["health"] == theirs["health"] == "healthy" and ours["backend"] == theirs["backend"] == "cpu"
    assert ours["finite"] is True and ours["chunks"] == ours["final_chunk_id"] == 2 and ours["rms"] > 1e-4
    for k in ("load_s", "ttfa_ms", "ttfa_steady_ms", "wall_s", "wall_steady_s", "realtime_x"):
        assert ours[k] >= 0, k
    (a, sr_a), (b, sr_b) = wavs["aiohttp"], wavs["jax"]
    assert sr_a == sr_b == 24000 and a.shape == b.shape and round(a.size / sr_a, 2) == ours["audio_s"]
    np.testing.assert_allclose(a, b, atol=1.01 * LSB16, rtol=0)


def test_ws_smoke_transports_agree(ws_runs):
    reports, wavs = ws_runs
    over_aiohttp, in_memory = reports["aiohttp"], reports["memory"]
    assert over_aiohttp["transport"] == "aiohttp" and in_memory["transport"] == "memory"
    assert set(over_aiohttp) == set(in_memory)
    assert {k: over_aiohttp[k] for k in AUDIO_KEYS} == {k: in_memory[k] for k in AUDIO_KEYS}
    assert (in_memory["health"], in_memory["backend"]) == ("healthy", "cpu")
    np.testing.assert_array_equal(wavs["aiohttp"][0], wavs["memory"][0])


def test_memory_socket_client_side():
    async def scenario():
        sock = MemorySocket()
        msgs = []

        async def service():  # echoes each text message as two frames
            async for msg in sock:
                if msg.data is None:
                    continue
                body = json.loads(msg.data)
                msgs.append((msg.type, body))
                await sock.send_bytes(b"\x00\x01")
                await sock.send_json({"type": "done", "n": body["n"]})

        task = asyncio.create_task(service())
        _, frames = await sock.request({"n": 1}, ("done",))
        await sock.send({"n": 2})
        after = [await sock.receive(5) for _ in range(2)]
        await sock.end()
        await asyncio.wait_for(task, 5)
        return msgs, frames, after

    msgs, frames, after = asyncio.run(scenario())
    assert [m[1] for m in msgs] == [{"n": 1}, {"n": 2}] and all(int(t) == 1 for t, _ in msgs)
    assert [(k, p) for _, k, p in frames] == [("binary", b"\x00\x01"), ("json", {"type": "done", "n": 1})]
    assert after == [("binary", b"\x00\x01"), ("json", {"type": "done", "n": 2})]
