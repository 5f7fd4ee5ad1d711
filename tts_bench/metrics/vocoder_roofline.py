"""The vocoder's least time over its device time, in percent, over the traced
sub-window: least time = max(operations / bf16 peak, bytes / HBM bandwidth) of each
call's shape (the cell's family's `vocoder_ops` and `vocoder_bytes`); device time =
the device time of the kernels launched inside the `record_function` range around
the vocoder's forward."""

from tts_bench import flops, spec

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "device_trace", "kernels"


def read(ctx):
    if ctx.probe is None:
        return None
    family, m, least, device_us = spec.family(ctx.cell), ctx.model, 0.0, 0.0
    for name, dev_us in ctx.probe.device["ranges"]:
        if name.startswith("tts_bench.vocoder:"):
            b, t = (int(x) for x in name.split(":")[1].split("x"))
            least += flops.least_seconds(family.vocoder_ops(m, b, t), family.vocoder_bytes(m, b, t), flops.PEAK_BF16)
            device_us += dev_us
    return 100.0 * least / (device_us / 1e6) if device_us > 0 else None
