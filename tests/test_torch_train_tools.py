"""The port's corpus diagnostics against the JAX package's tools, on the CPU.

* `tools.jitter_floor` vs tools/jitter_floor.py on a tiny variable-duration corpus (4
  sentences, 2 speakers, 2 held out), generated by each package's own
  `generate_corpus`: the two corpora's WAVs bit-equal first; then `n_utterances`,
  `n_speakers` and both length ratios equal, and both floors within two units of
  their last printed digit (2e-4, tests/test_torch_eval_tools.py's rule for rounded
  keys: two f32 log-mels that agree to ~1e-6 can print a last digit one apart). The
  refusals (no variable durations, no held-out sentences) print the JAX tool's line
  and exit 1.
* `tools.align_diag` vs tools/align_diag.py, both started from JAX's
  `aligner.init(PRNGKey(0), ModelConfig(), dim=16)` on the same corpus, 4 steps,
  `--eval-every 2`, the prior on; once plain and once with `--bin-weight 0.1
  --clip 1.0`. The step-0 grades equal key by key (integer MAS paths from the same
  parameters); the losses within rtol 1e-4 beyond the 4-decimal rounding both
  tools print; later grades within 0.05 on `dur_mae*` and 0.02 on `dur_corr*` (a
  single boundary can flip where two f32 path scores tie).
* `train/step.py`'s global-norm clip, which align_diag shares with the train step,
  against optax's.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gonova_tts_tpu.audio.mel import mel_spectrogram as jmel
from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.models import aligner as jaligner
from gonova_tts_tpu.train import synth_corpus as jsc
from gonova_tts_tpu_torch.config import ModelConfig
from gonova_tts_tpu_torch.text import text_to_ids
from gonova_tts_tpu_torch.tools import align_diag, jitter_floor
from gonova_tts_tpu_torch.train import synth_corpus as sc
from gonova_tts_tpu_torch.train.step import clip_by_global_norm_, global_norm
from gonova_tts_tpu_torch.utils import read_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]
SENTENCES = ("A dog ran.", "Go now!", "She saw him.", "We ate pie.")
FLOOR_KEYS = {"corpus", "n_utterances", "n_speakers", "floor_alt_jitter_mel_l1", "floor_mean_dur_mel_l1",
              "alt_len_ratio", "mean_len_ratio"}
GRADE_KEYS = {"step", "loss", "utts", "dur_mae", "dur_corr", "dur_mae_nonsil", "dur_corr_nonsil"}
ALIGN_ARGV = ["--steps", "4", "--eval-every", "2", "--dim", "16"]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_tool_main(name, argv, monkeypatch):
    """Run the JAX package's tools/<name>.py `main` in process on `argv`; returns
    (its stdout lines, its exit code)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out, rc = io.StringIO(), 0
    with contextlib.redirect_stdout(out):
        try:
            mod.main()
        except SystemExit as e:
            rc = e.code
    return out.getvalue().strip().splitlines(), rc


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(the JAX package's corpus, the port's), the same recipe, each by its own generator."""
    root = tmp_path_factory.mktemp("corpora")
    out = []
    for name, mod in (("jax", jsc), ("port", sc)):
        mod.generate_corpus(str(root / name), sentences=SENTENCES, speakers=mod.DEFAULT_SPEAKERS[:2],
                            variable=True, holdout=2)
        out.append(root / name)
    return tuple(out)


def test_generators_write_the_same_corpus(corpora):
    jdir, pdir = corpora
    wavs = sorted(p.name for p in jdir.glob("*.wav"))
    assert wavs == sorted(p.name for p in pdir.glob("*.wav")) and len(wavs) == 2 + 2 * len(SENTENCES)
    for name in wavs:
        a, sr_a = read_wav(str(jdir / name))
        b, sr_b = read_wav(str(pdir / name))
        assert sr_a == sr_b and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    jmeta, pmeta = (json.loads((d / "corpus_meta.json").read_text()) for d in corpora)
    assert jmeta == pmeta


# ---------------------------------------------------------------- jitter_floor


def test_jitter_floor_matches_jax_tool(corpora, monkeypatch, capsys):
    jdir, pdir = corpora
    rc = jitter_floor.main(["--corpus", str(pdir), "--device", "cpu"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lines, jrc = jax_tool_main("jitter_floor", ["--corpus", str(jdir)], monkeypatch)
    theirs = json.loads(lines[-1])
    assert rc == jrc == 0
    assert set(ours) == set(theirs) == FLOOR_KEYS and ours["corpus"] == str(pdir)
    for k in ("n_utterances", "n_speakers", "alt_len_ratio", "mean_len_ratio"):
        assert ours[k] == theirs[k], k
    for k in ("floor_alt_jitter_mel_l1", "floor_mean_dur_mel_l1"):
        assert abs(ours[k] - theirs[k]) <= 2e-4, (k, ours[k], theirs[k])
    # tests/test_train_data.py::test_jitter_floor_tool's bounds, on the port.
    assert ours["n_utterances"] == 4
    assert ours["floor_alt_jitter_mel_l1"] > 0.1 and ours["floor_mean_dur_mel_l1"] > 0.1
    assert 0.7 < ours["alt_len_ratio"] < 1.3 and 0.7 < ours["mean_len_ratio"] < 1.3


@pytest.mark.parametrize("case", ["uniform_durations", "no_holdout"])
def test_jitter_floor_refuses_as_jax_tool(case, corpora, tmp_path, monkeypatch, capsys):
    if case == "uniform_durations":
        corpus = str(tmp_path / "uniform")
        sc.generate_corpus(corpus, sentences=SENTENCES[:2], speakers=sc.DEFAULT_SPEAKERS[:1], holdout=1)
        extra = []
    else:
        corpus, extra = str(corpora[1]), ["--heldout", "0"]
    rc = jitter_floor.main(["--corpus", corpus, "--device", "cpu", *extra])
    ours = capsys.readouterr().out.strip().splitlines()
    theirs, jrc = jax_tool_main("jitter_floor", ["--corpus", corpus, *extra], monkeypatch)
    assert rc == jrc == 1
    assert ours == theirs == [json.dumps({"error": "corpus has no variable durations or no holdout"})]


@pytest.mark.parametrize("rate_variation", [False, True])
def test_mean_durations_match_jax_tool(rate_variation):
    spec = importlib.util.spec_from_file_location("jax_tool_jitter_floor", ROOT / "tools" / "jitter_floor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for text in SENTENCES + tuple(sc.DEFAULT_SENTENCES[:4]):
        ids = text_to_ids(text)
        assert jitter_floor.mean_durations(ids, text, rate_variation) == mod._mean_durations(
            ids, text, rate_variation)


def test_mel_of_pads_to_a_power_of_two_bucket():
    """The JAX tool's mel: zero padding to max(16384, next power of two) samples, then
    1 + n // hop frames (the plain JAX log-mel of the padded audio within 1e-4, the
    f32 DFT's spread at the floor). The unpadded mel has a frame fewer here, and its
    last frame differs from the padded one's."""
    cfg = ModelConfig()
    rng = np.random.default_rng(0)
    wav = (0.3 * rng.standard_normal(20000)).astype(np.float32)
    ours = jitter_floor.mel_of(wav, cfg, "cpu")
    padded = np.zeros(32768, np.float32)
    padded[: len(wav)] = wav
    theirs = np.asarray(jmel(
        jnp.asarray(padded)[None], sr=cfg.sample_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length, n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax,
    )[0])[: 1 + len(wav) // cfg.hop_length]
    assert ours.shape == theirs.shape == (1 + 20000 // cfg.hop_length, cfg.n_mels)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)
    unpadded = np.asarray(jmel(
        jnp.asarray(wav)[None], sr=cfg.sample_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length, n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax,
    )[0])
    assert len(unpadded) == len(ours) - 1
    assert np.abs(ours[len(unpadded) - 1] - unpadded[-1]).max() > 1e-2


# ---------------------------------------------------------------- align_diag


@pytest.fixture(scope="module")
def jax_aligner_tree():
    """JAX's aligner.init(PRNGKey(0), ModelConfig(), dim=16), the JAX tool's start."""
    return jax.tree_util.tree_map(np.asarray, jaligner.init(jax.random.PRNGKey(0), JModelConfig(), dim=16))


@pytest.mark.parametrize("extra", [[], ["--bin-weight", "0.1", "--clip", "1.0"]], ids=["plain", "bin_clip"])
def test_align_diag_matches_jax_tool(extra, corpora, jax_aligner_tree, monkeypatch):
    jdir, pdir = corpora
    emitted = []
    ours = align_diag.run(
        align_diag.parse_args(["--corpus", str(pdir), *ALIGN_ARGV, *extra, "--device", "cpu"]),
        params=jax_aligner_tree, emit=emitted.append,
    )
    lines, _ = jax_tool_main("align_diag", ["--corpus", str(jdir), *ALIGN_ARGV, *extra, "--cpu"], monkeypatch)
    theirs = [json.loads(x) for x in lines]
    assert [json.loads(x) for x in emitted] == ours["lines"]
    assert [x["step"] for x in ours["lines"]] == [x["step"] for x in theirs] == [0, 2, 4]
    assert all(set(x) == GRADE_KEYS for x in ours["lines"] + theirs)
    assert ours["lines"][0] == theirs[0] and theirs[0]["loss"] is None
    for a, b in zip(ours["lines"][1:], theirs[1:]):
        assert np.isfinite(a["loss"]) and abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]) + 1e-4, (a, b)
        assert a["utts"] == b["utts"] == 4
        for k in ("dur_mae", "dur_mae_nonsil"):
            assert abs(a[k] - b[k]) <= 0.05, (k, a, b)
        for k in ("dur_corr", "dur_corr_nonsil"):
            assert abs(a[k] - b[k]) <= 0.02, (k, a, b)
    # The port's own readings: the three warm steps after the first, on the CPU.
    assert ours["steps_timed"] == 3 and ours["ms_per_step"] > 0 and ours["device"] == "cpu"
    assert ours["launches_per_step"] is None and ours["device_idle_share"] is None


def test_align_diag_cpu_flag_and_seeded_init(corpora):
    """`--cpu` is `--device cpu`; without a tree the aligner starts from
    `aligner.init` seeded 0, the same parameters each run."""
    args = align_diag.parse_args(["--corpus", str(corpora[1]), "--steps", "1", "--eval-every", "1",
                                  "--dim", "8", "--cpu"])
    runs = [align_diag.run(args, emit=lambda line: None)["lines"] for _ in range(2)]
    assert runs[0] == runs[1] and [x["step"] for x in runs[0]] == [0, 1]
    assert np.isfinite(runs[0][1]["loss"]) and runs[0][0]["utts"] == 4


# ---------------------------------------------------------------- the clip


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), ())]
    theirs, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    ours = [torch.tensor(g) for g in grads]
    norm = global_norm(ours)
    np.testing.assert_allclose(float(norm), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
    clip_by_global_norm_(ours, norm, max_norm)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
