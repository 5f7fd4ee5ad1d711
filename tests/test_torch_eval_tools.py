"""The port's graders of a trained checkpoint on the CPU: `tools.eval_checkpoint`
and `tools.clone_eval` end to end at a tiny config on a tiny npz and a tiny
variable-duration corpus (the JAX tools' JSON keys, the exit rule), each held key by
key against the JAX tool (`tools/eval_checkpoint.py`, `clone_eval.py`, run in
process on the same npz and corpus at the same tiny config, both in f32), and their metric
helpers against the JAX package's functions on the same arrays: the log-mel (atol
1e-4 on log values, the f32 DFT's spread at the floor), MCD (rtol 1e-5), the clone
margin and the duration ratio (exact).

The tools print their numbers rounded (4 decimals, MCD 3): two f32 engines that
agree to ~1e-6 can still print a last digit one apart, so a key agrees within two
units of its last printed digit; the streamed-vs-batch reading within one int16
LSB, the JAX engine's own invariant at this tiny config."""

import contextlib
import importlib.util
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gonova_tts_tpu.config as jconfig
from gonova_tts_tpu.audio.mel import mcd as jmcd
from gonova_tts_tpu.audio.mel import mel_spectrogram as jmel
from gonova_tts_tpu_torch.config import Config, ModelConfig
from gonova_tts_tpu_torch.models.tts import TTS
from gonova_tts_tpu_torch.tools import clone_eval, eval_checkpoint
from gonova_tts_tpu_torch.train.checkpoint import save_params_npz
from gonova_tts_tpu_torch.train.synth_corpus import DEFAULT_SENTENCES, DEFAULT_SPEAKERS, generate_corpus

TINY = dict(
    d_model=32, n_heads=2, d_ff=64, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocos_dim=32, vocos_ff=64, vocos_layers=1,
)
# The JAX tools' keys (tools/eval_checkpoint.py's result with a variable corpus and
# a held-out split; clone_eval.py's line).
EVAL_KEYS = {
    "checkpoint", "backend", "held_in_mel_l1", "held_in_mel_mse", "held_in_mcd_db", "held_in_acoustic_mel_l1",
    "vocoder_floor_mel_l1", "duration_len_ratio", "stream_vs_batch_max_lsb", "stream_len_match",
    "clone_same_voice_mean", "clone_cross_voice_mean", "clone_margin", "held_in_dur_mae_frames",
    "held_in_dur_corr", "held_out_mel_l1", "held_out_mcd_db", "held_out_acoustic_mel_l1", "held_out_len_ratio",
    "generalization_gap_mel_l1", "held_out_dur_mae_frames", "held_out_dur_corr",
}
UNSEEN_KEYS = {
    "n_speakers", "held_in_mel_l1", "held_in_acoustic_mel_l1", "len_ratio", "clone_same_voice_mean",
    "clone_cross_voice_mean", "clone_cross_train_mean", "clone_margin", "held_out_mel_l1",
}
CLONE_KEYS = {"metric", "voices", "same_voice_mean", "cross_voice_mean", "margin"}
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool(path: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{pathlib.Path(path).stem}", ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(path, argv, monkeypatch, capsys):
    """The JAX tool's `main` on `argv`, in process, with the tiny model config in
    f32 (the tools build a default `Config()`); returns (its JSON line, its exit
    code)."""

    config = jconfig.Config

    def tiny_config():
        cfg = config()
        cfg.model = jconfig.ModelConfig(**TINY, compute_dtype="float32")
        return cfg

    monkeypatch.setattr(jconfig, "Config", tiny_config)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    capsys.readouterr()
    rc = 0
    try:
        _jax_tool(path).main()
    except SystemExit as e:
        rc = e.code
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), rc


def assert_same_numbers(ours: dict, theirs: dict, skip=()):
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if k in skip:
            continue
        if isinstance(v, dict):
            assert_same_numbers(ours[k], v)
        elif isinstance(v, float):
            tol = 1.0 if k == "stream_vs_batch_max_lsb" else (2e-3 if k.endswith("mcd_db") else 2e-4)
            assert abs(ours[k] - v) <= tol, (k, ours[k], v)
        else:
            assert ours[k] == v, k


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(Config of the tiny model on the CPU in f32, its npz, a 2-speaker x 3-sentence
    variable-duration corpus with 1 sentence held out)."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("eval")
    mcfg = ModelConfig(**TINY, device="cpu", compute_dtype="float32")
    npz = str(root / "tiny.npz")
    save_params_npz(npz, TTS(mcfg, torch.Generator().manual_seed(1)))
    corpus = str(root / "corpus")
    generate_corpus(corpus, sentences=DEFAULT_SENTENCES[:3], speakers=DEFAULT_SPEAKERS[:2], variable=True, holdout=1)
    cfg = Config()
    cfg.model = mcfg
    return cfg, npz, corpus


def test_eval_checkpoint_end_to_end(tiny, capsys, monkeypatch):
    cfg, npz, corpus = tiny
    argv = ["--checkpoint", npz, "--corpus", corpus, "--sentences", "2", "--unseen-speakers", "2", "--f32"]
    rc = eval_checkpoint.main(argv + ["--device", "cpu"], cfg=cfg)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    theirs, jrc = run_jax_tool("tools/eval_checkpoint.py", argv + ["--cpu"], monkeypatch, capsys)
    assert_same_numbers(out, theirs)
    assert rc == jrc
    assert EVAL_KEYS <= set(out) and out["backend"] == "cpu" and out["checkpoint"] == npz
    assert UNSEEN_KEYS <= set(out["unseen_speakers"]) and out["unseen_speakers"]["n_speakers"] == 2
    numbers = [v for k, v in out.items() if isinstance(v, float)] + [
        v for v in out["unseen_speakers"].values() if isinstance(v, float)]
    assert numbers and all(np.isfinite(numbers))
    # f32 on the CPU: the streamed windows reproduce the one-shot audio (the JAX
    # engine's invariant) within one LSB.
    assert out["stream_vs_batch_max_lsb"] <= 1.0 and out["stream_len_match"] is True
    assert rc == (0 if out["clone_margin"] > 0 else 1)


def test_clone_eval_end_to_end(tiny, capsys, monkeypatch):
    cfg, npz, corpus = tiny
    runs = []
    for extra in ([], ["--voices-dir", corpus]):  # synthetic voices; a directory's WAVs, at most eight
        ours = clone_eval.main(["--checkpoint", npz, "--device", "cpu", *extra], cfg=cfg)
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ours
        theirs, _ = run_jax_tool("clone_eval.py", ["--checkpoint", npz, *extra], monkeypatch, capsys)
        assert_same_numbers(ours, theirs)
        runs.append(ours)
    out, refs = runs
    assert set(out) == CLONE_KEYS and out["voices"] == 4 and out["metric"] == "voice_clone_similarity"
    assert out["margin"] == pytest.approx(out["same_voice_mean"] - out["cross_voice_mean"], abs=2e-4)
    assert refs["voices"] == 8 and all(np.isfinite(refs[k]) for k in ("same_voice_mean", "cross_voice_mean"))


def test_mel_helpers_match_jax():
    rng = np.random.default_rng(0)
    mcfg = ModelConfig()
    wav = (0.3 * rng.standard_normal(24000)).astype(np.float32)
    ours = eval_checkpoint.mel_of(wav, mcfg, "cpu")
    theirs = np.asarray(jmel(
        jnp.asarray(wav)[None], sr=mcfg.sample_rate, n_fft=mcfg.n_fft, hop_length=mcfg.hop_length,
        win_length=mcfg.win_length, n_mels=mcfg.n_mels, fmin=mcfg.fmin, fmax=mcfg.fmax,
    )[0])
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-4)
    other = ours[:-3] + 0.1 * rng.standard_normal(ours[:-3].shape).astype(np.float32)
    d = eval_checkpoint.mel_distances(other, ours)  # over the overlapping frames
    t = len(other)
    diff = other - ours[:t]
    np.testing.assert_allclose(d["mcd_db"], float(jmcd(jnp.asarray(other), jnp.asarray(ours[:t]))), rtol=1e-5)
    np.testing.assert_allclose(d["mel_l1"], np.abs(diff).mean(), rtol=1e-6)
    np.testing.assert_allclose(d["mel_mse"], (diff**2).mean(), rtol=1e-6)
    np.testing.assert_allclose(
        d["logmel_dist_db"], (10.0 / np.log(10.0)) * np.sqrt(2.0 * (diff**2).sum(-1)).mean(), rtol=1e-6)
    assert eval_checkpoint.mel_l1(other, ours) == d["mel_l1"]


def test_margin_and_duration_ratio():
    same, cross = [0.9, 0.8], [0.1, 0.3, 0.2]
    assert eval_checkpoint.clone_margin(same, cross) == float(np.mean(same) - np.mean(cross))
    assert eval_checkpoint.len_ratio(90, 100) == 0.9
    assert eval_checkpoint.len_ratio(5, 0) == 5.0  # the JAX tool's max(len, 1)
