"""parity_gpu.py on the CPU: its metrics equal parity.py's (the JAX package's
mel_mse, mcd and multi_resolution_stft_loss) on the same arrays, rtol 1e-5; its
main prints its three lines with the five keys of parity.py's line at a small
config; the engine line (two-stage vs the one-shot pipeline) runs. On the CPU the kernel
wrappers run their plain versions, so the bf16 candidate differs from the f32
reference by bf16 alone."""

import json

import jax
import numpy as np
import pytest
import torch

import parity_gpu
from gonova_tts_tpu.audio.mel import mcd as jmcd
from gonova_tts_tpu.audio.mel import mel_mse as jmel_mse
from gonova_tts_tpu.train.losses import multi_resolution_stft_loss as jmrstft
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine
from gonova_tts_tpu_torch.models.tts import TTS
from gonova_tts_tpu_torch.train.checkpoint import save_params_npz

TINY = dict(
    d_model=32, n_heads=2, d_ff=64, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocos_dim=32, vocos_ff=64, vocos_layers=1,
)
KEYS = {"metric", "mel_mse", "mcd_db", "vocoder_mrstft", "pass"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


def test_gate_metrics_equal_parity_py():
    rng = np.random.default_rng(0)
    mel_ref = (rng.normal(size=(3, 40, 80)) - 5.0).astype(np.float32)
    mel_cand = (mel_ref + 0.02 * rng.normal(size=mel_ref.shape)).astype(np.float32)
    wav_ref = (0.2 * rng.normal(size=(3, 8192))).astype(np.float32)
    wav_cand = (wav_ref + 0.002 * rng.normal(size=wav_ref.shape)).astype(np.float32)
    ours = parity_gpu.gate(*(torch.as_tensor(a) for a in (mel_cand, mel_ref, wav_cand, wav_ref)))
    assert set(ours) == KEYS and ours["metric"] == "parity_bf16_vs_f32"
    mse, mcd_db, mr = (float(x) for x in jax.jit(
        lambda mc, mr_, wc, wr: (jmel_mse(mc, mr_), jmcd(mc, mr_), jmrstft(wc, wr))
    )(mel_cand, mel_ref, wav_cand, wav_ref))
    np.testing.assert_allclose(ours["mel_mse"], round(mse, 6), rtol=1e-5)
    np.testing.assert_allclose(ours["mcd_db"], round(mcd_db, 4), rtol=1e-5)
    np.testing.assert_allclose(ours["vocoder_mrstft"], round(mr, 4), rtol=1e-5)
    assert ours["pass"] is (mse < 1e-2 and mcd_db < 1.0 and mr < 0.3)
    worse = parity_gpu.gate(*(torch.as_tensor(a) for a in (mel_cand + 1.0, mel_ref, wav_cand, wav_ref)))
    assert worse["pass"] is False  # mel MSE 1.0 is over the 1e-2 limit


def test_main_prints_parity_py_keys(capsys, monkeypatch, tmp_path):
    """main prints its three lines (random init, checkpoint, engine) with parity.py's
    keys, on a small config with a checkpoint of that size in the demo's place."""
    cfg = ModelConfig(**TINY)
    small = str(tmp_path / "small.npz")
    save_params_npz(small, TTS(cfg, torch.Generator().manual_seed(1)))
    monkeypatch.setattr(parity_gpu, "DEMO", small)
    rc = parity_gpu.main(["--device", "cpu"], cfg=cfg)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [line["metric"] for line in lines] == ["parity_bf16_vs_f32"] * 2 + ["parity_bf16_two_stage_vs_one_shot"]
    assert [line["weights"] for line in lines] == ["random seed 0", "small.npz", "small.npz"]
    for line in lines:
        assert KEYS <= set(line) and line["device"] == "cpu"
        assert all(np.isfinite(line[k]) for k in ("mel_mse", "mcd_db", "vocoder_mrstft"))
        assert line["launches"] == {"transformer_stack": 0, "vocos_stack": 0}  # plain versions on the CPU
    assert rc == (0 if all(line["pass"] for line in lines) else 1)


def test_workload_is_parity_py_s():
    tokens, mask, spk, exagg, dur = parity_gpu.workload(ModelConfig(**TINY))
    assert tokens.shape == mask.shape == dur.shape == (3, 64)
    assert (dur == 5).all() and (exagg == 0.5).all() and (spk == 0).all() and spk.shape == (3, 32)
    assert [int(m.sum()) for m in mask] == [46, 46, 61]


def test_engine_line_on_the_cpu():
    cfg = Config()
    cfg.model = ModelConfig(**TINY, device="cpu", compute_dtype="float32")
    cfg.engine = EngineConfig()
    eng = TTSEngine(cfg, device="cpu")
    eng.load(warmup=False)
    line = parity_gpu.engine_parity(eng)
    assert KEYS <= set(line) and line["metric"] == "parity_bf16_two_stage_vs_one_shot"
    # f32 on the CPU: two-stage and one-shot audio within one PCM16 step.
    assert line["same_lengths"] and line["max_abs_diff"] <= 1.01 / 32767 and line["pass"]
    # The engine's pass vocoded a frame bucket below the one-shot worst case.
    assert 0 < eng.stats["vocode_frames_executed"] < eng.stats["vocode_frames_worstcase"]
