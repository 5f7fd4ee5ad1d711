"""What a `--trace 1` run reads besides the clock, all put in from this file:

  * counters: at the window's start and end, `DynamicBatcher.metrics`, every number
    of `TTSEngine.get_stats()` by its dotted name, and the histogram of every span
    of the engine's tracer (the service and the batcher record into the same one);
    `delta` and `span_window` give a reader the window's change in one of them;
  * spans: `text_to_ids` where the batcher calls it (host time per call);
  * pass shapes: each engine pass's (batch, token bucket, frame bucket), counted at
    the calls into `models.tts`;
  * the device: `torch.profiler` over a sub-window of `trace_s` seconds that starts
    `trace_at_s` into the window (all threads), with `record_function` ranges
    around the forward of each vocoder module the cell's family names
    (`VOCODER_FORWARDS`) and around the fused mel; an open-loop cell that clones
    voices starts it half a second before the first cloning request due after
    `trace_at_s`, so that a voice is embedded inside it.

A family counts what it does outside these calls in its own `install(svc, probe)`,
which `install` calls last. Nothing here is installed in a `--trace 0` run.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Probe:
    frontend_s: List[float] = field(default_factory=list)
    passes: collections.Counter = field(default_factory=collections.Counter)  # (B, L, T) → count
    embeds: int = 0
    counters0: Dict = field(default_factory=dict)  # at the window's start and end
    counters1: Dict = field(default_factory=dict)
    passes0: Dict = field(default_factory=dict)
    passes1: Dict = field(default_factory=dict)
    frontend0: int = 0  # len(frontend_s) at the window's start and end
    frontend1: int = 0
    start_s: float = 0.0  # how long the profiler took to start and to stop
    stop_s: float = 0.0
    prof: object = None
    sub_start: float = 0.0
    sub_end: float = 0.0
    device: Optional[dict] = None  # the reduction of the sub-window's trace
    _restore: List[Tuple[object, str, object]] = field(default_factory=list)

    def patch(self, obj, name: str, fn) -> None:
        self._restore.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    def unpatch(self) -> None:
        for obj, name, orig in reversed(self._restore):
            setattr(obj, name, orig)
        self._restore.clear()


def _numbers(tree: Dict, prefix: str = "") -> Dict[str, float]:
    """Every int or float leaf of a nested dict, by its dotted path (bools left out)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_numbers(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f"{prefix}{k}"] = v
    return out


def counters(svc) -> Dict:
    engine = svc.synthesizer.engine
    stats = engine.get_stats()
    return {"batcher": dict(svc.batcher.metrics),
            "engine": {k: stats[k] for k in ("real_tokens", "padded_tokens", "batches", "batched_requests")},
            "stats": _numbers({k: v for k, v in stats.items() if k != "timers"}),
            "spans": engine.tracer.histograms()}


def delta(ctx, name: str) -> Optional[float]:
    """The window's change in the engine counter `name` (a dotted key of
    `counters()["stats"]`; absent at the start: 0); None without a probe or where
    the counter is absent at the end."""
    if ctx.probe is None or name not in ctx.probe.counters1["stats"]:
        return None
    return ctx.probe.counters1["stats"][name] - ctx.probe.counters0["stats"].get(name, 0)


def span_window(ctx, name: str) -> Optional[dict]:
    """The window's `count`, `sum_s` and cumulative `buckets` (at the tracer's
    bounds and above) of the span `name`: the difference of its histograms at the
    window's edges; None without a probe or where the span was never recorded."""
    if ctx.probe is None or name not in ctx.probe.counters1["spans"]:
        return None
    b = ctx.probe.counters1["spans"][name]
    a = ctx.probe.counters0["spans"].get(name, {"count": 0, "sum_s": 0.0, "buckets": [0] * len(b["buckets"])})
    return {"count": b["count"] - a["count"], "sum_s": b["sum_s"] - a["sum_s"],
            "buckets": [y - x for x, y in zip(a["buckets"], b["buckets"])]}


def install(svc, probe: Probe, family) -> None:
    import importlib

    from torch.profiler import record_function

    from gonova_tts_tpu_torch.engine import batcher as batcher_mod
    from gonova_tts_tpu_torch.engine import engine as engine_mod
    from gonova_tts_tpu_torch.models import tts

    to_ids = batcher_mod.text_to_ids

    def timed_ids(text):
        t0 = time.perf_counter()
        try:
            return to_ids(text)
        finally:
            probe.frontend_s.append(time.perf_counter() - t0)

    probe.patch(batcher_mod, "text_to_ids", timed_ids)

    encode = tts.encode_acoustic

    def counted_encode(params, tokens, *args, **kw):
        probe.passes[("enc", tokens.shape[0], tokens.shape[1])] += 1
        return encode(params, tokens, *args, **kw)

    decode_vocode = tts.decode_vocode

    def counted_decode(params, enc, spk, durations, token_mask, max_frames, *args, **kw):
        probe.passes[("dec", enc.shape[0], enc.shape[1], int(max_frames))] += 1
        return decode_vocode(params, enc, spk, durations, token_mask, max_frames, *args, **kw)

    synthesize = tts.synthesize

    def counted_synth(params, tokens, *args, **kw):
        cfg = args[4] if len(args) > 4 else kw["cfg"]
        probe.passes[("enc", tokens.shape[0], tokens.shape[1])] += 1
        probe.passes[("dec", tokens.shape[0], tokens.shape[1], tokens.shape[1] * cfg.max_frames_per_token)] += 1
        return synthesize(params, tokens, *args, **kw)

    probe.patch(tts, "encode_acoustic", counted_encode)
    probe.patch(tts, "decode_vocode", counted_decode)
    probe.patch(tts, "synthesize", counted_synth)

    def ranged(fn, label):
        def wrapped(params, mel, *args, **kw):
            with record_function(f"tts_bench.{label}:{mel.shape[0]}x{mel.shape[1]}"):
                return fn(params, mel, *args, **kw)
        return wrapped

    for name in family.VOCODER_FORWARDS:
        mod = importlib.import_module(f"gonova_tts_tpu_torch.models.{name}")
        probe.patch(mod, "forward", ranged(mod.forward, "vocoder"))

    mel = engine_mod.mel_spectrogram_fused

    def ranged_mel(x, *args, **kw):
        probe.embeds += 1
        with record_function(f"tts_bench.mel:{x.shape[0]}x{x.shape[-1]}"):
            return mel(x, *args, **kw)

    probe.patch(engine_mod, "mel_spectrogram_fused", ranged_mel)
    if hasattr(family, "install"):
        family.install(svc, probe)


def _profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        config = None
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=activities, experimental_config=config)


def warm_profiler() -> None:
    """Start and stop one profile at set-up: the first start of the device tracer
    takes seconds, which must not fall in the window."""
    import torch

    with _profiler():
        torch.ones(8).sum()


def start_profiler(probe: Probe) -> None:
    probe.prof = _profiler()
    t0 = time.perf_counter()
    probe.prof.start()
    probe.sub_start = time.perf_counter()
    probe.start_s = probe.sub_start - t0


def stop_profiler(probe: Probe) -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    probe.sub_end = time.perf_counter()
    probe.prof.stop()
    probe.stop_s = time.perf_counter() - probe.sub_end


async def sub_window(probe: Probe, mix: dict, w0: float, w1: float, at: float = None) -> None:
    """Profile `trace_s` seconds from `at` (default: `trace_at_s` into the window, a
    third of a shorter window)."""
    import asyncio

    if at is None:
        at = w0 + min(mix["trace_at_s"], (w1 - w0) / 3)
    await asyncio.sleep(max(0.0, at - time.perf_counter()))
    start_profiler(probe)
    await asyncio.sleep(mix["trace_s"])
    stop_profiler(probe)


GAPS_NAMED = 400  # the longest idle gaps named by their host event


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(probe: Probe) -> dict:
    """The sub-window's device busy time, kernel totals, the ranges' device time,
    and the longest idle gaps by what the host was doing (the innermost host event
    open at the gap's middle, on any thread)."""
    from torch.autograd import DeviceType

    events = probe.prof.events()
    window_us = (probe.sub_end - probe.sub_start) * 1e6
    device, host, ranges = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, max(a, 0.0), min(b, window_us)))
        else:
            host.append((a, b, e.name))
            if e.name.startswith("tts_bench."):
                ranges.append((e.name, e.device_time_total))
    device = [d for d in device if d[2] > d[1]]
    busy = _merge([(a, b) for _, a, b in device])
    busy_us = sum(b - a for a, b in busy)
    kernels, calls = collections.Counter(), collections.Counter()
    for name, a, b in device:
        kernels[name] += b - a
        calls[name] += 1
    gaps = []
    edges = [(0.0, 0.0)] + busy + [(window_us, window_us)]
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b - a > 0:
            gaps.append((a, b))
    by_host = collections.Counter()
    if host:
        import numpy as np

        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
            mid = (a + b) / 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = host[inside[np.argmin(he[inside] - hs[inside])]][2] if len(inside) else "no host event"
            by_host[name] += (b - a) / 1e6
    return {
        "window_s": window_us / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels_s": {k: v / 1e6 for k, v in kernels.items()},
        "kernel_calls": dict(calls),
        "ranges": ranges,
        "device_ops": [[k, v / 1e6] for k, v in kernels.most_common(10)],
        "idle_gaps": [[k, v] for k, v in by_host.most_common(10)],
    }
