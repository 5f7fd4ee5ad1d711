#!/usr/bin/env python3
"""Drive the PyTorch port (gonova_tts_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the final line:
  1. device: name and power limit (nvidia-smi); no card → exit 3, no result.
  2. build: every gonova_tts_tpu_torch/csrc/*.cu with nvcc for sm_90a, in parallel.
  3. kernels: each hand-written kernel vs its plain PyTorch version on the card, at
     the serving path's shapes, f32 and bf16: max |error| against a stated bound,
     kernel and plain times (CUDA events), and the least time the card could take.
  4. engine: the demo checkpoint (assets/checkpoints/demo_ema_f16.npz, full width,
     30.1 M parameters) in bf16 with both kernel switches on — batch one-graph and
     two-stage, streaming, a 128-token sentence whose decoder takes the plain
     local-attention route — with launch counts reset just before and read just
     after; then agreement checks and audio-seconds per second.
  5. output: a `kernels` JSON line, the nvidia-smi line, then the `ok` JSON line.

Bounds (max |error| unless named):
  kernels f32: 2e-3 (summation order through up to 8 layers);
  kernels bf16: KERNEL_BF16_BOUND (a one-ulp bf16 flip at a rounding point, ~0.4%,
    carried through the later layers);
  two-stage vs one-graph, streamed vs one-shot: see ENGINE_BOUNDS;
  bf16 kernel path vs f32 plain path: relative L2 error of the audio at the same
    durations, BF16_VS_F32_REL_L2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

KERNEL_F32_BOUND = 1e-4
KERNEL_BF16_BOUND = 0.1
# Audio is PCM16 in [-1, 1]; one LSB is 1/32767. In bf16 the kernels give the same
# rows at any frame bucket, but cuBLAS and cuDNN pick other algorithms for other
# shapes (the mel and STFT-head products, the embed conv), and a bf16 rounding flip
# there moves the audio by tens of LSB; in f32 the same dispatch stays within 2 LSB.
ENGINE_BOUNDS = {
    "two_stage_vs_one_graph": 0.08,
    "two_stage_vs_one_graph_plain_local": 0.1,
    "stream_vs_one_shot": 0.03,
    "f32_two_stage_vs_one_graph": 2.01 / 32767,
}
BF16_VS_F32_REL_L2 = 0.1

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 off the tensor cores
DEMO = os.path.join("assets", "checkpoints", "demo_ema_f16.npz")
SENTENCES = [  # 25, 42, 45 and 60 tokens: one batch in the 64-token bucket
    "Hello there, how are you today?",
    "The quick brown fox jumps over the lazy dog.",
    "Please call Stella and ask her to bring these things.",
    "We paid $42.50 for 17 widgets.",
]
STREAM_TEXT = "Streaming starts before the sentence ends. A second sentence follows the first one."
LONG_SENTENCE = (  # 97 tokens: the 128-token bucket, 1024 one-graph frames
    "This longer sentence keeps going with many more words, so that its phoneme count "
    "lands in the next bucket up."
)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float, dtype_name: str):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------ phase 3


def transformer_cases(model, torch, dev, rng):
    """Encoder B=4 T=64; decoder B=4 T=512 (full attention); decoder B=4 T=256
    with local attention w=64. Real checkpoint weights, prefix masks."""
    import numpy as np

    from gonova_tts_tpu_torch.ops import transformer_stack as ts

    cases = []
    for name, stack, b, t, window in (
        ("encoder", model.acoustic.encoder, 4, 64, None),
        ("decoder", model.acoustic.decoder, 4, 512, None),
        ("decoder_local", model.acoustic.decoder, 4, 256, 64),
    ):
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            packed = ts.pack_params(stack, dt)
            lengths = np.array([t, t - t // 4, t // 2, t // 3 + 5])[:b]
            mask = torch.as_tensor((np.arange(t)[None] < lengths[:, None]).astype(np.float32), device=dev)
            x = (torch.as_tensor(rng.standard_normal((b, t, 256)).astype(np.float32), device=dev) * mask[..., None]).to(dt)
            out = ts.transformer_stack(x, mask, packed, 4, window, bf16)
            ref = ts.transformer_stack_plain(x, mask, packed, 4, window, bf16)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            ok = bool(torch.isfinite(out.float()).all()) and err <= (KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND)
            d, f, n_layers = 256, packed["w1"].shape[-1], packed["w1"].shape[0]
            m = b * t
            span = 3 * window if window and 2 * window < t else t
            flops = n_layers * (
                2 * m * d * 3 * d + 4 * b * t * span * d + 2 * m * d * d + 2 * m * 3 * d * f * 2
            )
            moved = nbytes(x, mask, out, *packed.values())
            bound_ms, bound_by = bound(moved, flops, str(dt).split(".")[-1])
            cases.append({
                "case": f"{name} B={b} T={t}" + (f" w={window}" if window else ""),
                "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                "tolerance": KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND, "ok": ok,
                "ms": cuda_ms(lambda: ts.transformer_stack(x, mask, packed, 4, window, bf16), 10),
                "plain_ms": cuda_ms(lambda: ts.transformer_stack_plain(x, mask, packed, 4, window, bf16), 10),
                "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            })
    return cases


def vocos_cases(model, torch, dev, rng):
    """B=4 T=320 (a two-stage frame bucket) and B=1 T=122 (the streaming window)."""
    from gonova_tts_tpu_torch.ops import vocos_stack as vs

    cases = []
    for b, t in ((4, 320), (1, 122)):
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            packed = vs.pack_params(model.vocoder.blocks, dt)
            x = torch.as_tensor(rng.standard_normal((b, t, 512)).astype("float32"), device=dev).to(dt)
            out = vs.vocos_stack(x, packed, bf16)
            ref = vs.vocos_stack_plain(x, packed, bf16)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            ok = bool(torch.isfinite(out.float()).all()) and err <= (KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND)
            c, f, n_layers = 512, packed["w1"].shape[-1], packed["w1"].shape[0]
            flops = n_layers * b * t * (4 * c * f + 2 * 7 * c)
            moved = nbytes(x, out, *packed.values())
            bound_ms, bound_by = bound(moved, flops, str(dt).split(".")[-1])
            cases.append({
                "case": f"B={b} T={t}", "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                "tolerance": KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND, "ok": ok,
                "ms": cuda_ms(lambda: vs.vocos_stack(x, packed, bf16), 10),
                "plain_ms": cuda_ms(lambda: vs.vocos_stack_plain(x, packed, bf16), 10),
                "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            })
    return cases


# ------------------------------------------------------------------ phase 4


def engine_config(dtype: str, kernels: bool):
    from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig

    cfg = Config()
    cfg.model = ModelConfig(model_path=DEMO, compute_dtype=dtype, vocos_pallas=kernels)
    cfg.engine = EngineConfig(acoustic_pallas=kernels, warmup_shapes=[[1, 32], [4, 32], [4, 64]])
    return cfg


def pinned(engine, mode, texts):
    engine.ecfg.two_stage_batch = mode
    return engine.synthesize_batch(texts)


def max_diff(a_list, b_list) -> float:
    worst = 0.0
    for a, b in zip(a_list, b_list):
        if a.shape != b.shape:
            return float("inf")
        worst = max(worst, float(abs(a - b).max()) if a.size else 0.0)
    return worst


def run_engine(torch, np, report):
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.engine import TTSEngine
    from gonova_tts_tpu_torch.models import tts

    t0 = time.perf_counter()
    eng = TTSEngine(engine_config("bfloat16", kernels=True))
    eng.load(warmup=True)
    report["engine_load_s"] = time.perf_counter() - t0
    report["two_stage_auto_resolved"] = eng.two_stage_enabled  # before any pinning
    if not (eng.mcfg.acoustic_pallas and eng.mcfg.vocos_pallas):
        fail("kernel switches did not reach the model config")

    # The main path: launch counts from zero, read right after.
    ops.reset_launch_counts()
    one = pinned(eng, False, SENTENCES)
    two = pinned(eng, True, SENTENCES)
    chunks = list(eng.synthesize_stream(STREAM_TEXT))
    long_one = pinned(eng, False, [LONG_SENTENCE])
    long_two = pinned(eng, True, [LONG_SENTENCE])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    n_requests = 2 * len(SENTENCES) + 1 + 2
    report["main_path"] = {"requests": n_requests, "launches": launches}

    from gonova_tts_tpu_torch.text import batch_to_bucket, pick_bucket, segment_text, text_to_ids

    long_bucket = pick_bucket(len(text_to_ids(LONG_SENTENCE)), eng.ecfg.token_buckets)
    streamed = np.concatenate(chunks)
    # One-shot reference: each sentence alone, at the shapes the stream used.
    whole = np.concatenate([pinned(eng, False, [s])[0] for s in segment_text(STREAM_TEXT)])
    checks = {
        "finite_nonempty": all(np.isfinite(w).all() and w.size > 0 for w in one + two + chunks + long_one + long_two),
        "launches_positive": all(launches.get(k, 0) > 0 for k in ("transformer_stack", "vocos_stack")),
        "long_sentence_bucket_128": long_bucket == 128,
    }
    diffs = {
        "two_stage_vs_one_graph": max_diff(one, two),
        "two_stage_vs_one_graph_plain_local": max_diff(long_one, long_two),
        "stream_vs_one_shot": max_diff([streamed], [whole]),
    }
    for k, v in diffs.items():
        checks[k] = v <= ENGINE_BOUNDS[k]

    # bf16 kernel path vs f32 plain path, at the same durations: f32 encode, then
    # decode + vocode in both modes from the same token-domain result.
    ref = TTSEngine(engine_config("float32", kernels=False))
    ref.load(warmup=False)
    ids = [text_to_ids(s) for s in SENTENCES]
    tokens, lengths, bucket = batch_to_bucket(ids, eng.ecfg.token_buckets)
    dev = eng.device
    tok = torch.as_tensor(tokens, device=dev)
    mask = torch.as_tensor((np.arange(bucket)[None] < lengths[:, None]).astype(np.float32), device=dev)
    spk = torch.zeros((len(ids), eng.mcfg.speaker_dim), device=dev)
    ex = torch.full((len(ids),), 0.5, device=dev)
    t_full = bucket * eng.mcfg.max_frames_per_token
    with torch.inference_mode():
        e = tts.encode_acoustic(ref.params, tok, mask, spk, ex, ref.mcfg, torch.float32)
        e_bf = tts.encode_acoustic(eng.params, tok, mask, spk, ex, eng.mcfg, torch.bfloat16)
        a32 = tts.decode_vocode(ref.params, e["enc"], e["spk"], e["durations"], mask, t_full, ref.mcfg, torch.float32)["audio"]
        abf = tts.decode_vocode(
            eng.params, e["enc"].bfloat16(), e["spk"].bfloat16(), e["durations"], mask, t_full, eng.mcfg,
            torch.bfloat16,
        )["audio"].float()
    rel = float(torch.linalg.norm(abf - a32) / torch.linalg.norm(a32))
    enc_rel = float(torch.linalg.norm(e_bf["enc"].float() - e["enc"]) / torch.linalg.norm(e["enc"]))
    same_durations = int((e_bf["durations"] == e["durations"]).all(dim=1).sum())
    checks["bf16_vs_f32"] = rel <= BF16_VS_F32_REL_L2

    # The dispatch rule itself, in f32 through the kernels: two-stage == one-graph.
    ref.mcfg = ref.mcfg.model_copy(update={"acoustic_pallas": True, "vocos_pallas": True})
    k = "f32_two_stage_vs_one_graph"
    diffs[k] = max_diff(pinned(ref, False, SENTENCES), pinned(ref, True, SENTENCES))
    checks[k] = diffs[k] <= ENGINE_BOUNDS[k]
    report["agreement"] = {
        **diffs, "bounds": ENGINE_BOUNDS,
        "bf16_kernel_vs_f32_plain_audio_rel_l2_same_durations": rel,
        "bf16_vs_f32_bound": BF16_VS_F32_REL_L2,
        "bf16_vs_f32_encoder_rel_l2": enc_rel,
        "bf16_vs_f32_rows_with_equal_durations": f"{same_durations}/{len(ids)}",
    }
    report["checks"] = checks

    # Serving speed, two-stage, warm.
    speed = {}
    for b in (1, 4, 16):
        texts = [SENTENCES[i % len(SENTENCES)] for i in range(b)]
        pinned(eng, True, texts)
        torch.cuda.synchronize()
        reps, t0, samples = 5, time.perf_counter(), 0
        for _ in range(reps):
            samples += sum(w.size for w in pinned(eng, True, texts))
        dt = time.perf_counter() - t0
        speed[f"batch{b}"] = {
            "audio_s_per_s": samples / eng.sample_rate / dt, "latency_ms_per_batch": dt / reps * 1e3,
        }
    t0 = time.perf_counter()
    gen = eng.synthesize_stream(STREAM_TEXT)
    next(gen)
    speed["stream_first_chunk_ms"] = (time.perf_counter() - t0) * 1e3
    list(gen)
    report["speed"] = speed
    report["profile_batch4_two_stage"] = profile(eng, torch, speed["batch4"]["latency_ms_per_batch"])
    return launches, checks


def profile(eng, torch, unprofiled_ms: float) -> dict:
    """Device time by kernel over one warm batch-4 two-stage request. The first
    profiled run pays the tracer's start-up and is discarded; the idle share is
    taken against the request's unprofiled latency."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for _ in range(2):
        pinned(eng, True, SENTENCES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pinned(eng, True, SENTENCES)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    if not rows:
        return {"note": "the profiler saw no device time: not measured"}
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {
        "profiled_wall_ms": wall_ms, "unprofiled_latency_ms": unprofiled_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / unprofiled_ms),
        "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": n} for us, k, n in rows[:14]],
    }


def main() -> None:
    try:
        import numpy as np
        import torch

        from gonova_tts_tpu_torch.config import ModelConfig
        from gonova_tts_tpu_torch.device import resolve_device
        from gonova_tts_tpu_torch.models import params
        from gonova_tts_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the root of a checkout", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device", 3)
    dev = resolve_device("cuda")
    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    try:
        built = _build.build_all()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    print(f"build: {json.dumps({k: round(v, 1) for k, v in built.items()})} in {time.perf_counter() - t0:.1f} s", flush=True)

    model, _ = params.load_checkpoint(DEMO, ModelConfig(), dev)
    rng = np.random.default_rng(0)
    report = {}
    ts_cases = transformer_cases(model, torch, dev, rng)
    vs_cases = vocos_cases(model, torch, dev, rng)
    for c in ts_cases + vs_cases:
        print("kernel case: " + json.dumps(c), flush=True)
    del model
    launches, checks = run_engine(torch, np, report)
    print("engine: " + json.dumps(report), flush=True)

    def entry(name, route_src, replaces, cases, main_case):
        rep = next(c for c in cases if c["case"] == main_case and c["dtype"] == "bfloat16")
        return {
            "name": name, "route": "cuda", "source": route_src, "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": None,
            "at": f"{main_case} bf16", "cases": cases,
        }

    kernels = [
        entry("transformer_stack", "gonova_tts_tpu_torch/csrc/transformer_stack.cu",
              "gonova_tts_tpu/ops/transformer_stack_kernel.py:332", ts_cases, "decoder B=4 T=512"),
        entry("vocos_stack", "gonova_tts_tpu_torch/csrc/vocos_stack.cu",
              "gonova_tts_tpu/ops/vocos_stack_kernel.py:143", vs_cases, "B=4 T=320"),
    ]
    bad = [f"{c['case']} {c['dtype']}" for c in ts_cases + vs_cases if not c["ok"]]
    bad += [k for k, v in checks.items() if not v]
    if bad:
        print(json.dumps({"kernels": kernels}), flush=True)
        fail(f"checks failed: {bad}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
