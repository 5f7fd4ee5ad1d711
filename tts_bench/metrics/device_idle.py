"""The share of the traced sub-window in which no operation ran on the card, in
percent (torch.profiler's device activity, merged)."""

UNIT, BETTER, SOURCE, LAYER = "%", "lower", "device_trace", "device"


def read(ctx):
    if ctx.probe is None or ctx.probe.device["window_s"] <= 0:
        return None
    d = ctx.probe.device
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
