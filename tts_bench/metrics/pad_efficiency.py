"""Real tokens over padded tokens of the window's passes, in percent: the change
over the window in the engine's `real_tokens` and `padded_tokens`."""

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "program_counter", "engine"


def read(ctx):
    if ctx.probe is None:
        return None
    a, b = ctx.probe.counters0["engine"], ctx.probe.counters1["engine"]
    padded = b["padded_tokens"] - a["padded_tokens"]
    return 100.0 * (b["real_tokens"] - a["real_tokens"]) / padded if padded else None
