"""The port's CLI (`gonova_tts_tpu_torch.cli`) against the JAX package's, on the CPU.

Both read one config file (tests/test_service_ws.py's tiny model, `model.device: cpu`,
one seeded checkpoint written by the JAX package's `save_params_npz`). `synth` writes a
WAV within one int16 step of the JAX CLI's; `voices` and `info` print JSON with the JAX
CLI's keys; `serve` builds the app (aiohttp's `run_app` replaced by a recorder).
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

from gonova_tts_tpu import cli as jcli
from gonova_tts_tpu_torch import cli
from gonova_tts_tpu_torch.service import TTSService, VoiceManager
from gonova_tts_tpu_torch.utils import read_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOICE_WAV = ROOT / "assets" / "default_voice.wav"
MODEL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    upsample_initial_channel=32, vocos_dim=128, vocos_ff=256, vocos_layers=2,
    compute_dtype="float32",
)
ENGINE = dict(
    token_buckets=[32, 64, 128, 192], batch_buckets=[1, 4], max_batch=4,
    stream_chunk_frames=24, stream_context_frames=8, warmup_shapes=[[1, 32]],
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    import jax

    from gonova_tts_tpu.config import ModelConfig as JModelConfig
    from gonova_tts_tpu.models import tts as jtts
    from gonova_tts_tpu.train.checkpoint import save_params_npz

    tmp = tmp_path_factory.mktemp("cli")
    ckpt = save_params_npz(
        str(tmp / "tiny.npz"), jtts.init(jax.random.PRNGKey(0), JModelConfig(**MODEL)), dtype="float32"
    )
    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump({
        "model": {**MODEL, "model_path": ckpt, "device": "cpu"},
        "engine": ENGINE,
        "voice_cloning": {"cache_dir": str(tmp / "voices")},
        "logging": {"level": "WARNING"},
    }))
    return str(path)


@pytest.mark.parametrize("voice", [None, VOICE_WAV], ids=["default_voice", "cloned_voice"])
def test_synth_matches_jax_cli(config_file, tmp_path, voice):
    text = "The command line speaks. Then it stops."
    args = ["synth", text, "--config", config_file] + (["--voice-wav", str(voice)] if voice else [])
    assert cli.main(args + ["-o", str(tmp_path / "port.wav")]) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.wav")]) == 0
    ours, sr = read_wav(str(tmp_path / "port.wav"))
    theirs, jsr = read_wav(str(tmp_path / "jax.wav"))
    assert sr == jsr == 24000 and ours.shape == theirs.shape and ours.size > 0
    a, b = np.round(ours * 32768).astype(np.int32), np.round(theirs * 32768).astype(np.int32)
    assert int(np.abs(a - b).max()) <= 1


def test_synth_device_comes_from_the_config(monkeypatch, tmp_path):
    """With no config file the device is the default "cuda": without a card `synth`
    raises instead of running on the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["synth", "Hello.", "-o", str(tmp_path / "x.wav")])


def test_voices_prints_the_jax_clis_json(config_file, capsys):
    import asyncio
    import base64

    cache = yaml.safe_load(pathlib.Path(config_file).read_text())["voice_cloning"]["cache_dir"]
    payload = base64.b64encode(VOICE_WAV.read_bytes()).decode()
    asyncio.run(VoiceManager(cache_dir=cache).register_voice("cli-voice", payload))
    outputs = []
    for main in (cli.main, jcli.main):
        assert main(["voices", "--config", config_file]) == 0
        outputs.append(json.loads(capsys.readouterr().out))
    assert outputs[0] == outputs[1]
    assert [v["voice_id"] for v in outputs[0]] == ["cli-voice"]


def test_info_has_the_jax_clis_keys(capsys):
    assert cli.main(["info"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jcli.main(["info"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert set(theirs) <= set(ours)
    assert ours["version"] == theirs["version"]
    assert ours["jax_backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert ours["torch_version"] == torch.__version__
    assert set(theirs["model_families"]) == {"novaspeech", "novagan", "novavocos", "novaspk", "novatts"}
    # BigVGAN-v2 and F5-TTS are the port's alone: the JAX package has no such models.
    assert set(ours["model_families"]) == set(theirs["model_families"]) | {"bigvgan", "f5tts"}
    assert set(ours["model_families"]["bigvgan"]) == set(ours["model_families"]["f5tts"]) == {"kind", "description"}
    assert ours["model_families"]["bigvgan"]["kind"] == "vocoder"
    assert ours["model_families"]["f5tts"]["kind"] == "acoustic"
    for name, family in theirs["model_families"].items():
        assert set(ours["model_families"][name]) == set(family) == {"kind", "description"}
        assert ours["model_families"][name]["kind"] == family["kind"]


def test_serve_builds_the_app(config_file, monkeypatch):
    from aiohttp import web

    calls = []
    monkeypatch.setattr(web, "run_app", lambda app, host, port: calls.append((app, host, port)))
    assert cli.main(["serve", "--config", config_file, "--port", "9123"]) == 0
    (app, host, port), = calls
    svc = app["service"]
    assert isinstance(svc, TTSService) and port == 9123 and host == svc.config.server.host
    assert svc.synthesizer.engine.device == torch.device("cpu")
    assert {r.resource.canonical for r in app.router.routes()} >= {
        "/v1/stream/tts", "/health", "/metrics", "/v1/synthesize",
    }
