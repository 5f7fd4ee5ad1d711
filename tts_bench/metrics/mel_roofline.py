"""The fused log-mel's least time over its device time, in percent, over the traced
sub-window: least time = max(operations / the split-TF32 peak, bytes / HBM
bandwidth) of each launch (flops.mel_kernel, at the shape of the engine's call, which
the `record_function` range around that call names, else the engine's 10 s analysis
buffer); device time = the device time
of the kernel `csrc/mel_spectrogram.cu` launches (`mel_kernel`). The kernel is
launched through its own C library, not an aten op, so its time is read by name."""

from tts_bench import flops

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "device_trace", "kernels"
KERNEL = "mel_kernel"


def read(ctx):
    if ctx.probe is None:
        return None
    d, m = ctx.probe.device, ctx.model
    launches = sum(n for k, n in d["kernel_calls"].items() if KERNEL in k)
    device_s = sum(t for k, t in d["kernels_s"].items() if KERNEL in k)
    if not launches or device_s <= 0:
        return None
    shapes = [name.split(":")[1] for name, _ in d["ranges"] if name.startswith("tts_bench.mel:")]
    n = int(10 * m["sample_rate"]) // m["hop_length"] * m["hop_length"]
    b, n = (int(x) for x in shapes[0].split("x")) if shapes else (1, n)
    frames = n // m["hop_length"]
    ops, moved = flops.mel_kernel(frames, m["n_fft"], m["n_mels"], 4 * b * n, 4 * b * frames * m["n_mels"])
    return 100.0 * launches * flops.least_seconds(b * ops, moved, flops.PEAK_TF32_SPLIT) / device_s
