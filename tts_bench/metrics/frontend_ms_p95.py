"""The 95th percentile (nearest rank) of the host time of `text_to_ids` where the
batcher calls it, over the window's calls (a span put in by trace.py)."""

from tts_bench.drive import nearest_rank

UNIT, BETTER, SOURCE, LAYER = "ms", "lower", "program_span", "text frontend"


def read(ctx):
    if ctx.probe is None:
        return None
    spans = ctx.probe.frontend_s[ctx.probe.frontend0 : ctx.probe.frontend1]
    return 1e3 * nearest_rank(spans, 0.95) if spans else None
