"""Median time from a request's scheduled send to its first binary audio frame,
over every request due in the window; a failed request counts as +inf."""

from tts_bench.drive import nearest_rank

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(ctx):
    ttfa = ctx.window.ttfa_ms()
    return nearest_rank(ttfa, 0.50) if ttfa else None
