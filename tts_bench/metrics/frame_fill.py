"""The frames of the window's F5 rows over the frames their passes ran, in percent:
the change over the window in the engine's `f5_real_frames` (Σ L of the rows) over
its change in `f5_padded_frames` (batch bucket x frame bucket of each pass). None
where the window ran no F5 pass (or the program has no such counter)."""

from tts_bench import trace

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "program_counter", "engine"


def read(ctx):
    real, padded = trace.delta(ctx, "f5_real_frames"), trace.delta(ctx, "f5_padded_frames")
    if real is None or not padded:
        return None
    return 100.0 * real / padded
