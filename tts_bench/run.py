"""Run one cell of the benchmark once, in this process, and print its result.

    python3 tts_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (`setup_s`, timed from the start of this
process to the service's readiness): the port's `TTSService` on the cell's
configuration, warm-up of the cell's shapes, and the loop's own set-up (its
voices). Then `ramp_s` seconds of traffic that no metric counts, the window of
`--seconds`, the check against the plain reference of the configuration's model
family (`families/<family>.py`, check.py), and
the result: the last line of standard output is one JSON object with `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` with `--trace 1`), the
numbers compared last under `check`; the same numbers are the last lines of
standard error. `--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (trace.py).

It exits with another code than 0, and prints no result, without a CUDA card (or
fewer than the cell asks for), where the served program is not this checkout's, and
where the process holds JAX or the JAX package once the window has closed. Every
file it writes lies under the temporary directory (`TMPDIR`) of the run, removed at
exit, or in the checkout's `build/` (the port's compiled kernels). The host's
math libraries run one thread each (`THREADS`): the served path is host-bound, and
idle pools spinning beside its Python threads make runs spread.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gonova_tts_tpu")
THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def held_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: no reading"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: not found"


async def run_cell(cell, args, device: str, tmp: str) -> dict:
    import torch

    from tts_bench import check, host, loadgen, serve, spec, trace

    loop, family = spec.loop(cell), spec.family(cell)
    cfg = serve.port_config(cell, args.seed, device, tmp)
    gen = loadgen.Generator(cell.mix, args.seed)
    voices = serve.make_voices(cell, args.seed)
    svc = await serve.start(cell, cfg, voices)
    setup_s = time.perf_counter() - T_PROCESS
    watch = host.Host(svc)
    probe = None
    if args.trace:
        probe = trace.Probe()
        trace.install(svc, probe, family)
        trace.warm_profiler()

    t0 = time.perf_counter() + 0.05
    w0, w1 = t0 + cell.mix["ramp_s"], t0 + cell.mix["ramp_s"] + args.seconds
    async def marks():
        await asyncio.sleep(max(0.0, w0 - time.perf_counter()))
        watch.mark(True)
        await asyncio.sleep(max(0.0, w1 - time.perf_counter()))
        watch.mark(False)

    side = [asyncio.create_task(marks())]
    if probe:
        async def counters():
            await asyncio.sleep(max(0.0, w0 - time.perf_counter()))
            probe.counters0, probe.passes0, probe.frontend0 = trace.counters(svc), dict(probe.passes), len(probe.frontend_s)
            await asyncio.sleep(max(0.0, w1 - time.perf_counter()))
            probe.counters1, probe.passes1, probe.frontend1 = trace.counters(svc), dict(probe.passes), len(probe.frontend_s)

        at = loop.trace_at(gen, cell.mix, t0, w0, args.seconds)
        side += [asyncio.create_task(counters()), asyncio.create_task(trace.sub_window(probe, cell.mix, w0, w1, at))]
    window = await loop.run(svc, gen, cell.mix, voices, t0, args.seconds)
    await asyncio.gather(*side)
    watch.close()

    dev = svc.synthesizer.engine.device
    n_dev = max(1, cell.chips)
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(n_dev)) if dev.type == "cuda" else 0
    two_stage = svc.synthesizer.engine.two_stage_enabled
    await svc.shutdown()
    if probe:
        probe.unpatch()
        t_reduce = time.perf_counter()
        probe.device = trace.reduce(probe)
        probe.device["reduce_s"] = time.perf_counter() - t_reduce
        probe.prof = None
    del svc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    measured = window.measured
    judge = family.judge(cfg.model.model_dump(), cfg.engine.model_dump(), cfg.model.model_path, dev)
    voice_of = check.voice_of(voices, open(cfg.voice_cloning.default_voice_path, "rb").read())
    picked = check.sample(measured, cell.mix, args.seed)
    numbers, other = check.judge(measured, picked, judge, voice_of, cell.mix["exaggeration"], cell.limits)
    return dict(window=window, measured=measured, probe=probe, host=watch.readings(window), numbers=numbers,
                other=other, peak=peak,
                setup_s=setup_s, two_stage=two_stage, model=cfg.model.model_dump(), dev=dev)


def execute(args, device: str = "cuda", cell=None):
    """(exit code, the info line, the result) of one run; the result is None where
    the run may print none. The CPU, and a `cell` given rather than named, serve
    only the tests."""
    sys.path.insert(0, ROOT)
    import torch

    from tts_bench import check, spec
    from tts_bench.drive import nearest_rank

    if cell is None:
        cell = spec.load_cell(args.workload, bench=spec.benchmark())
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"tts_bench: cell {cell.name} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 3, None, None
    import gonova_tts_tpu_torch

    if not os.path.abspath(gonova_tts_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"tts_bench: gonova_tts_tpu_torch comes from {gonova_tts_tpu_torch.__file__}, not {ROOT}", file=sys.stderr)
        return 4, None, None

    tmp = tempfile.mkdtemp(prefix="tts_bench_")
    try:
        out = asyncio.run(run_cell(cell, args, device, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    held = held_forbidden()
    if held:
        print(f"tts_bench: the process holds {', '.join(held)} after the window", file=sys.stderr)
        return 5, None, None

    ctx = types.SimpleNamespace(cell=cell, mix=cell.mix, seconds=args.seconds, **out)  # what a reader reads
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = out["dev"]
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": out["peak"],
    }
    measured = out["measured"]
    late = [r.late for r in measured]
    info = {
        "cell": cell.name, "seed": args.seed, "card": card_line() if dev.type == "cuda" else "cpu",
        "sent": len(measured), "completed": sum(not r.failed for r in measured),
        "failed": sum(r.failed for r in measured), "errors": sorted({r.error for r in measured if r.failed})[:3],
        "generator_late_ms_p50": 1e3 * nearest_rank(late, 0.5) if late else 0.0,
        "generator_late_ms_max": 1e3 * max(late, default=0.0),
        "audio_s": out["window"].audio_s(), "setup_s": out["setup_s"], "memory_peak_bytes": out["peak"],
        "two_stage": out["two_stage"], "compared": out["other"]["compared"], "gap_db": out["other"]["gap_db"],
        "reference_s": out["other"]["reference_s"], "worst": out["other"]["worst"], **out["host"],
    }
    result = {"correct": check.correct(out["numbers"]), "attempted": len(measured),
              "failed": info["failed"], "metrics": metrics, "device": device_info}
    probe = out["probe"]
    if probe is not None:
        d = probe.device
        device_info["busy_s"], device_info["window_s"] = d["busy_s"], d["window_s"]
        result["breakdown"] = {"device_ops": d["device_ops"], "idle_gaps": d["idle_gaps"]}
        info["trace_reduce_s"] = d["reduce_s"]
        info["profiler_start_s"], info["profiler_stop_s"] = probe.start_s, probe.stop_s
        info["traced_mel_ranges"] = sum(name.startswith("tts_bench.mel:") for name, _ in d["ranges"])
        info["traced_mel_launches"] = sum(n for k, n in d["kernel_calls"].items() if "mel_kernel" in k)
    result["check"] = out["numbers"]
    return 0, info, result


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from tts_bench import check

    code, info, result = execute(parse(argv))
    if result is None:
        return code
    print(json.dumps(info), flush=True)
    for line in check.lines(result["check"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.update(THREADS)  # before numpy and torch load
    try:
        code = main()
    except Exception:  # noqa: BLE001 — a failed run reports why and prints no result
        traceback.print_exc()
        code = 1
    sys.exit(code)
