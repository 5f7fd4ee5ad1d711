"""The F5 sampler's least time over its device time, in percent, over the traced
sub-window: least time = the sum, over the sampler calls the sub-window ranged
(`tts_bench.f5:BxL`, put in by families/f5.py), of max(operations / the bf16 peak,
bytes / HBM bandwidth) (the family's `dit_ops` and `dit_bytes`: the text embedding
once and every Euler step's DiT over both guidance rows); device time = the device
time of the kernels launched inside those ranges. None without such a range."""

from tts_bench import flops, spec

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "device_trace", "kernels"


def read(ctx):
    if ctx.probe is None:
        return None
    family = spec.family(ctx.cell)
    if not hasattr(family, "dit_ops"):
        return None
    least, device_us = 0.0, 0.0
    for name, dev_us in ctx.probe.device["ranges"]:
        if name.startswith("tts_bench.f5:"):
            b, length = (int(x) for x in name.split(":")[1].split("x"))
            least += flops.least_seconds(family.dit_ops(ctx.model, b, length), family.dit_bytes(ctx.model, b, length),
                                         flops.PEAK_BF16)
            device_us += dev_us
    return 100.0 * least / (device_us / 1e6) if device_us > 0 else None
