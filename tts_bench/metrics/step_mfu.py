"""The operations of every pass the window ran (the cell's family's `pass_ops`, at
each pass's batch, token bucket and frame bucket), over the window's length, over
the card's bf16 peak, in percent."""

from tts_bench import flops, spec

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "program_counter", "model passes"


def read(ctx):
    if ctx.probe is None:
        return None
    family, ops = spec.family(ctx.cell), 0
    for key, n in ctx.probe.passes1.items():
        ops += (n - ctx.probe.passes0.get(key, 0)) * family.pass_ops(ctx.model, key)
    return 100.0 * ops / ctx.window.seconds / flops.PEAK_BF16 if ops else None
