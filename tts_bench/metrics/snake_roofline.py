"""The anti-aliased Snake-beta kernel's least time over its device time, in percent,
over the traced sub-window: least time = the sum, over the activations of every
vocoder forward the sub-window ranged (`tts_bench.vocoder:BxT`), of max(operations /
the f32 peak, bytes / HBM bandwidth) (the cell's family's `snake_least_seconds`);
device time = the device time of the kernels named `snake_aa_kernel`. The kernel is
launched through its own C library, not an aten op, so its time is read by name.
None where the window launched none (the change in `get_stats()`'s
`kernel_launches.snake_aa`, which a program without the kernel lacks) or the family
counts no activation."""

from tts_bench import spec, trace

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "device_trace", "kernels"
KERNEL = "snake_aa_kernel"


def read(ctx):
    if ctx.probe is None or not trace.delta(ctx, "kernel_launches.snake_aa"):
        return None
    family = spec.family(ctx.cell)
    if not hasattr(family, "snake_least_seconds"):
        return None
    d = ctx.probe.device
    device_s = sum(t for k, t in d["kernels_s"].items() if KERNEL in k)
    least = 0.0
    for name, _ in d["ranges"]:
        if name.startswith("tts_bench.vocoder:"):
            b, t = (int(x) for x in name.split(":")[1].split("x"))
            least += family.snake_least_seconds(ctx.model, b, t)
    return 100.0 * least / device_s if device_s > 0 and least > 0 else None
