"""The mean time of the window's engine passes, in ms: the change over the window in
the `engine.pass` span's sum over the change in its count (the engine's tracer times
that span with its switch off too). A mean and not a tail: the histogram's buckets
are 1.58x wide, its sum and count exact."""

from tts_bench import trace

UNIT, BETTER, SOURCE, LAYER = "ms", "lower", "program_span", "engine"


def read(ctx):
    w = trace.span_window(ctx, "engine.pass")
    return 1e3 * w["sum_s"] / w["count"] if w and w["count"] else None
