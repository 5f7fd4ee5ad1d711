"""The operations of every pass the window ran (flops.py, at each pass's batch,
token bucket and frame bucket), over the window's length, over the card's bf16
peak, in percent."""

from tts_bench import flops

UNIT, BETTER, SOURCE, LAYER = "%", "higher", "program_counter", "model passes"


def read(ctx):
    if ctx.probe is None:
        return None
    m, ops = ctx.model, 0
    for key, n in ctx.probe.passes1.items():
        n -= ctx.probe.passes0.get(key, 0)
        if key[0] == "enc":
            ops += n * flops.encode(m, key[1], key[2])
        else:
            _, b, length, frames = key
            local = length * m["max_frames_per_token"] >= m["local_attention_min_frames"]
            ops += n * (flops.decode(m, b, frames, local) + flops.vocoder(m, b, frames))
    return 100.0 * ops / ctx.window.seconds / flops.PEAK_BF16 if ops else None
