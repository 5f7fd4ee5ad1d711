"""Audio seconds served in the window, over the window's length: every sentence's
audio that came back in the window, of every call that did not fail (drive.Window).
A document of 20-60 sentences is too coarse a unit: which of the callers' documents
straddle the window's edges would move the rate by several percent."""

UNIT, BETTER, SOURCE = "audio-s/s", "higher", "host_clock"


def read(ctx):
    return ctx.window.audio_s() / ctx.window.seconds
