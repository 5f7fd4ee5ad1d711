"""The share of the window's engine passes that replayed CUDA graphs, in percent:
the change over the window in `get_stats()`'s `graph_passes`, over its change in
`graph_passes` and `eager_passes` (a pass counts in one of the two)."""

from tts_bench import trace

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "program_counter", "engine"


def read(ctx):
    graphed, eager = trace.delta(ctx, "graph_passes"), trace.delta(ctx, "eager_passes")
    if graphed is None or eager is None or graphed + eager == 0:
        return None
    return 100.0 * graphed / (graphed + eager)
