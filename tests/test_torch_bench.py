"""The port's measurement tools against the JAX package's, on the CPU.

* `tools.bench`: the workload (t_full, the two-stage frame bucket, audio a pass) equals
  bench.py's formulas over the JAX `ModelConfig()` / `EngineConfig()`; at a tiny config,
  with JAX's seeded init carried across by `params.from_numpy_tree`, the port's
  one-graph pass, both two-stage halves and TTFA's first window equal the JAX
  functions bench.py times on the same inputs, f32, within tests/test_torch_models.py's
  atol 1e-4 / rtol 1e-3 (f32 through several layers in another summation order). The
  last line has exactly the contract's four keys; without a card and without
  `--device cpu` the tool (and `gonova-tts-torch bench`) prints the one-line
  `cuda_unavailable` diagnostic and exits 1.
* `tools.mfu`: the FLOPs of the same three graphs at the tiny config within 5% below
  XLA's `cost_analysis` of the JAX graphs. The port counts products and convolutions
  (`FlopCounterMode`); XLA also counts elementwise operations, so the port's count is
  the lower one. The count does not change with the kernel switches on; the JSON has
  the JAX tool's keys.
* `tools.bench_suite`: configs 1 (single_short) and 4 (multi_speaker) at `--tiny`, the
  port's engine serving the JAX engine's seeded params, give the JAX suite's keys and
  its `audio_s`; the tiny config is the JAX suite's.
* The four microbenchmarks, each at a tiny shape, print the JAX tools' keys (`xla` read
  as `plain`).
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.config import EngineConfig as JEngineConfig
from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.models import acoustic as jacoustic
from gonova_tts_tpu.models import tts as jtts
from gonova_tts_tpu_torch import cli
from gonova_tts_tpu_torch.config import EngineConfig, ModelConfig
from gonova_tts_tpu_torch.models import params
from gonova_tts_tpu_torch.tools import bench, bench_acoustic, bench_hifigan, bench_suite, bench_tstack
from gonova_tts_tpu_torch.tools import bench_vocos_attr, mfu

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-4, 1e-3
TINY = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    upsample_initial_channel=32, vocos_dim=128, vocos_ff=256, vocos_layers=2, compute_dtype="float32",
)
CONTRACT_KEYS = {"metric", "value", "unit", "vs_baseline"}
DETAIL_KEYS = {"mode", "one_graph", "two_stage_compute", "ttfa_p50_ms", "ttfa_p90_ms"}  # bench.py's


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def jax_module(path: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{pathlib.Path(path).stem}", ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_workload(cfg, ecfg):
    """bench.py:134-160's shapes, as it computes them."""
    batch, bucket, frames_per_token = 16, 64, 5
    t_full = bucket * cfg.max_frames_per_token
    need = bucket * frames_per_token + ecfg.stream_context_frames
    fb = min((x for x in ecfg.vocode_frame_buckets if x >= need), default=t_full)
    fb = min(fb, t_full)
    stride = ecfg.stream_chunk_frames
    w_first = stride + 2 * min(ecfg.stream_context_frames, stride)
    return t_full, fb, batch * bucket * frames_per_token * cfg.hop_length / cfg.sample_rate, w_first


@pytest.mark.parametrize("buckets", [None, [128, 192]])
def test_workload_matches_the_jax_bench(buckets):
    """The default frame buckets (384 covers 320 + 29), and buckets that cover nothing
    (the fallback to the one-graph frame count)."""
    jecfg = JEngineConfig() if buckets is None else JEngineConfig(vocode_frame_buckets=buckets)
    ecfg = EngineConfig() if buckets is None else EngineConfig(vocode_frame_buckets=buckets)
    t_full, fb, audio_sec, w_first = jax_workload(JModelConfig(), jecfg)
    wl = bench.workload(ModelConfig(), ecfg)
    assert (wl.t_full, wl.fb, wl.audio_sec, wl.w_first) == (t_full, fb, audio_sec, w_first)
    assert (wl.batch, wl.bucket, wl.frames_per_token) == (16, 64, 5)
    assert wl.fb == (384 if buckets is None else 512)


@pytest.fixture(scope="module")
def jax_graphs():
    """bench.py's graphs at the tiny config (its seeded init, its inputs), each jitted
    once; the compiled executables also give XLA's FLOP counts."""
    jcfg, ecfg = JModelConfig(**TINY), JEngineConfig()
    t_full, fb, _, w_first = jax_workload(jcfg, ecfg)
    p = jax.jit(lambda k: jtts.init(k, jcfg))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(4, 48, (16, 64)), jnp.int32)
    mask = jnp.ones((16, 64), jnp.float32)
    speaker = jnp.asarray(rng.standard_normal((16, jcfg.speaker_dim)), jnp.float32)
    exagg = jnp.full((16,), 0.5, jnp.float32)
    durations = jnp.full((16, 64), 5, jnp.int32)

    def one_pass(params, speaker):
        ac = jacoustic.forward(params["acoustic"], tokens, mask, speaker, exagg, jcfg, durations=durations)
        return jtts.vocode(params, ac["mel"], jcfg)

    def encode_pass(params, speaker):
        e = jacoustic.encode(params["acoustic"], tokens, mask, speaker, exagg, jcfg, durations=durations)
        return e["enc"], e["spk"]

    def decode_pass(params, enc, spkp):
        d = jacoustic.decode(params["acoustic"], enc, spkp, durations, mask, fb, jcfg,
                             local_attention_from=t_full)
        return jtts.vocode(params, d["mel"], jcfg)

    def acoustic_first(params, spk1):
        ac = jacoustic.forward(params["acoustic"], tokens[:1], mask[:1], spk1, exagg[:1], jcfg,
                               durations=durations[:1])
        return jax.lax.dynamic_slice_in_dim(ac["mel"], 0, w_first, axis=1)

    enc0, spk0 = jax.jit(encode_pass)(p, speaker)
    compiled = {
        "one_graph": jax.jit(one_pass).lower(p, speaker).compile(),
        "encode": jax.jit(encode_pass).lower(p, speaker).compile(),
        "decode": jax.jit(decode_pass).lower(p, enc0, spk0).compile(),
    }
    tree = jax.tree_util.tree_map(np.asarray, p)
    return {
        "tree": tree, "compiled": compiled, "speaker": speaker, "tokens": tokens, "enc0": enc0, "spk0": spk0,
        "acoustic_first": jax.jit(acoustic_first), "vocode": jax.jit(lambda params, m: jtts.vocode(params, m, jcfg)),
        "params": p,
    }


def test_bench_passes_match_jax(jax_graphs):
    g = jax_graphs
    cfg = ModelConfig(**TINY)
    model = params.from_numpy_tree(g["tree"], cfg, device="cpu")
    wl = bench.workload(cfg, EngineConfig())
    x = bench.inputs(cfg, wl, "cpu")
    np.testing.assert_array_equal(x["tokens"].numpy(), np.asarray(g["tokens"]))
    np.testing.assert_array_equal(x["speaker"].numpy(), np.asarray(g["speaker"]))
    fns = bench.passes(model, cfg, wl, x, torch.float32)
    p = g["params"]
    with torch.inference_mode():
        close(fns["one_graph"](x["speaker"]), g["compiled"]["one_graph"](p, g["speaker"]))
        enc, spk = fns["encode"](x["speaker"])
        close(enc, g["enc0"])
        close(spk, g["spk0"])
        close(fns["decode"](enc, spk), g["compiled"]["decode"](p, g["enc0"], g["spk0"]))
        window = fns["acoustic_first"](x["speaker"][:1])
        jwindow = g["acoustic_first"](p, g["speaker"][:1])
        assert window.shape == jwindow.shape == (1, wl.w_first, cfg.n_mels)
        close(window, jwindow)
        close(fns["vocode_window"](window), g["vocode"](p, jwindow))


def test_mfu_count_matches_xla_cost_analysis(jax_graphs):
    def xla(name):
        ca = jax_graphs["compiled"][name].cost_analysis()
        return float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])

    ours = mfu.pass_flops(ModelConfig(**TINY), EngineConfig())
    for name in ("one_graph", "encode", "decode"):
        assert 0.95 * xla(name) <= ours[name] <= xla(name), (name, ours[name], xla(name))
    # The count is of the plain path whatever the switches say.
    on = ModelConfig(**TINY, acoustic_pallas=True, vocos_pallas=True)
    assert mfu.pass_flops(on, EngineConfig()) == ours


def test_mfu_prints_the_jax_tool_json(monkeypatch, capsys):
    monkeypatch.setattr(mfu, "ModelConfig", lambda: ModelConfig(**TINY))
    assert mfu.main(["--one-graph", "100", "--two-stage", "150", "--peak-tflops", "989", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"workload", "peak_tflops_bf16", "rows"} <= set(out) and out["device"] == "cpu"
    assert out["workload"] == "B=16 L=64 fpt=5 (T_one=512, T_two=384)"
    assert [r["mode"] for r in out["rows"]] == ["one_graph", "two_stage"]
    for r in out["rows"]:
        assert set(r) == {"mode", "gflops_per_pass", "wall_ms_per_pass", "audio_s_per_s", "mfu_pct"}
    assert out["rows"][0]["wall_ms_per_pass"] == round(54.61333333 / 100 * 1e3, 3)
    with pytest.raises(SystemExit, match="--peak-tflops"):  # no peak is known for the CPU
        mfu.main(["--one-graph", "100", "--device", "cpu"])


def test_bench_main_prints_the_contract_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "ModelConfig", lambda: ModelConfig(**TINY))
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    detail, last = json.loads(lines[-2])["detail"], json.loads(lines[-1])
    assert set(last) == CONTRACT_KEYS and last["metric"] == "audio_sec_per_sec_per_chip"
    # value and vs_baseline are each rounded from the unrounded throughput.
    assert last["value"] > 0 and abs(last["vs_baseline"] - last["value"] / 60.0) <= 1e-3
    assert DETAIL_KEYS <= set(detail) and detail["device"] == "cpu" and detail["dtype"] == "f32"
    assert last["value"] == max(detail["one_graph"], detail["two_stage_compute"])
    assert detail["one_graph_device_ms"] is None  # no device reading on the CPU
    assert 0 < detail["ttfa_p50_ms"] <= detail["ttfa_p90_ms"]


def test_bench_without_a_card_prints_the_diagnostic():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool runs on it")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "gonova_tts_tpu_torch.tools.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    elapsed = time.monotonic() - t0
    assert proc.returncode == 1
    data = json.loads(proc.stdout.strip().splitlines()[-1])
    assert data["error"] == "cuda_unavailable" and data["metric"] == "audio_sec_per_sec_per_chip"
    assert elapsed < 30, f"diagnostic path too slow: {elapsed:.0f}s"


def test_cli_bench_runs_the_tool(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool runs on it")
    assert cli.main(["bench"]) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["error"] == "cuda_unavailable"


# ------------------------------------------------------------------ the suite


@pytest.fixture(scope="module")
def suite_engines(tmp_path_factory):
    """(the JAX engine, the port's), both at the JAX suite's tiny config and serving the
    JAX engine's seeded params; the JAX config as its `_engine(tiny=True)` builds it."""
    from gonova_tts_tpu import engine as jengine
    from gonova_tts_tpu.train.checkpoint import save_params_npz
    from gonova_tts_tpu_torch.engine import TTSEngine

    jsuite = jax_module("bench_suite.py")
    made = []

    class Capture:
        def __init__(self, cfg):
            made.append(cfg)

        def load(self, warmup=True):
            pass

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "TTSEngine", Capture)
        mp.setattr(jax.config, "update", lambda *a: None)  # its compile-cache setting
        jsuite._engine(True)
    jcfg = made[0]
    cfg = bench_suite.suite_config(True, "cpu")
    assert cfg.model.speaker_n_mels is None  # the port's field alone: None reads n_mels
    # the F5 family's fields are the port's alone too (acoustic_family "nova" by default)
    port_only = {"speaker_n_mels", "acoustic_family"} | {k for k in type(cfg.model).model_fields if k.startswith("f5_")}
    assert cfg.model.acoustic_family == "nova"
    assert cfg.model.model_dump(exclude={"device"} | port_only) == jcfg.model.model_dump(exclude={"device"})
    ours, theirs = cfg.engine.model_dump(exclude={"f5_frame_buckets"}), jcfg.engine.model_dump()
    assert ours == {k: theirs[k] for k in ours}
    # The port serves one dispatch: the JAX engine's mode switch and its threshold have no field.
    assert len(set(theirs) - set(ours)) == 2 and all(k.startswith("two_stage_") for k in set(theirs) - set(ours))
    jeng = jengine.TTSEngine(jcfg)
    jeng.load(warmup=False)
    path = save_params_npz(str(tmp_path_factory.mktemp("suite") / "tiny.npz"), jeng.params, dtype="float32")
    cfg.model.model_path = path
    eng = TTSEngine(cfg)
    eng.load(warmup=False)
    return jsuite, jeng, eng


@pytest.mark.parametrize("name", ["bench_single_short", "bench_multi_speaker"])
def test_suite_config_matches_jax(suite_engines, name):
    jsuite, jeng, eng = suite_engines
    with contextlib.redirect_stdout(io.StringIO()) as out:
        getattr(jsuite, name)(jeng)
    theirs = json.loads(out.getvalue().strip().splitlines()[-1])
    with contextlib.redirect_stdout(io.StringIO()):
        ours = getattr(bench_suite, name)(eng)
    assert set(ours) == set(theirs) and ours["config"] == theirs["config"]
    assert ours["audio_s"] == theirs["audio_s"] > 0
    if name == "bench_multi_speaker":
        assert ours["recompiles"] == theirs["recompiles"] == 0 and ours["voices"] == 6


# ------------------------------------------------------------------ microbenchmarks

SMALL = ModelConfig(**TINY)


def tstack_keys():
    out = bench_tstack.run("cpu", d=64, heads=4, ff=128, n_layers=1, cases=(("enc", 2, 16, None), ("loc", 2, 48, 8)),
                           k=1, repeats=1)
    assert set(out) == {"enc", "loc"}
    assert all(c["max_abs_err"] == 0.0 for c in out.values())  # the wrapper runs its plain twin here
    return [set(c) for c in out.values()], {"xla_ms", "fused_ms", "speedup"}


def acoustic_keys():
    out = bench_acoustic.run("cpu", 2, 16, SMALL, k=1, repeats=1)
    jax_keys = {"batch", "bucket", "acoustic_xla_ms", "pipeline_xla_ms", "acoustic_fused_ms", "pipeline_fused_ms",
                "acoustic_speedup", "pipeline_speedup"}
    return [set(out)], jax_keys


def vocos_attr_keys():
    out = bench_vocos_attr.run("cpu", 2, 20, SMALL, k=1, repeats=1)
    return [set(out)], {"full_ms", "mlps_only_ms", "vpu_only_ms", "head_istft_ms", "head_istft_cartesian_ms",
                        "full_cartesian_ms"}


def hifigan_keys():
    b, t, sweep = 2, 10, ((16, 256), (32, 64))
    out = bench_hifigan.run("cpu", b, t, SMALL, sweep=sweep, k=1, repeats=1)
    jax_keys = {"full_pass_ms", "audio_sec_per_sec", "folded_pass_ms", "folded_audio_sec_per_sec", "folded_speedup"}
    t_cur, ch = t, SMALL.upsample_initial_channel  # tools/bench_hifigan.py's stage names
    for i, rate in enumerate(SMALL.upsample_rates):
        t_cur, ch = t_cur * rate, ch // 2
        jax_keys.add(f"mrf_stage{i}_T{t_cur}_C{ch}_ms")
    jax_keys |= {f"conv_fixedflop_C{c}_T{tc}_ms" for c, tc in sweep}
    assert out["folded_speedup"] > 0 and out["audio_sec_per_sec"] > 0
    return [set(out)], jax_keys


@pytest.mark.parametrize("tool", [tstack_keys, acoustic_keys, vocos_attr_keys, hifigan_keys],
                         ids=["bench_tstack", "bench_acoustic", "bench_vocos_attr", "bench_hifigan"])
def test_microbenchmark_prints_the_jax_tool_keys(tool):
    key_sets, jax_keys = tool()
    want = {k.replace("xla", "plain") for k in jax_keys}
    for keys in key_sets:
        assert want <= keys, want - keys
        # Each time has its device-busy twin beside it (None on the CPU).
        assert {k.replace("_ms", "_device_ms") for k in want if k.endswith("_ms")} <= keys
