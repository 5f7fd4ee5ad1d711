"""Requests per device pass: the change over the window in `DynamicBatcher.metrics`
`requests` over its change in `batches` (a bucket split counts as its passes)."""

UNIT, BETTER, SOURCE, LAYER = "requests/pass", "higher", "program_counter", "batcher"


def read(ctx):
    if ctx.probe is None:
        return None
    a, b = ctx.probe.counters0["batcher"], ctx.probe.counters1["batcher"]
    passes = b["batches"] - a["batches"]
    return (b["requests"] - a["requests"]) / passes if passes else None
