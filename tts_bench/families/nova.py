"""The nova family: the port's FastPitch-class acoustic model (`models/acoustic.py`)
with NovaVocos (`vocoder_family` "vocos") or the HiFi-GAN generator ("hifigan"),
served through `models/tts.py`. Its plain reference is reference/model.py, judged by
check.Judge; its operations and bytes are flops.py's.
"""

from __future__ import annotations

from tts_bench import check, flops

VOCODERS = ("vocos", "hifigan")  # the `vocoder_family` values reference/model.py and flops.py know
VOCODER_FORWARDS = ("vocos", "vocoder", "vocoder_folded")


def _known(m: dict) -> dict:
    if m["vocoder_family"] not in VOCODERS:
        raise ValueError(f"the nova family has no vocoder {m['vocoder_family']!r}: a new one is a family of its own")
    return m


def judge(model: dict, engine: dict, checkpoint: str, device, numerics: str = "fp32") -> check.Judge:
    return check.Judge(_known(model), engine, checkpoint, device, numerics)


def pass_ops(m: dict, key: tuple) -> int:
    """("enc", B, L): the token half; ("dec", B, L, T): the frame half and the
    vocoder, with local attention as the one-graph length decides it."""
    if key[0] == "enc":
        return flops.encode(m, key[1], key[2])
    _, b, length, frames = key
    local = length * m["max_frames_per_token"] >= m["local_attention_min_frames"]
    return flops.decode(m, b, frames, local) + vocoder_ops(m, b, frames)


def vocoder_ops(m: dict, b: int, frames: int) -> int:
    return flops.vocoder(_known(m), b, frames)


def vocoder_bytes(m: dict, b: int, frames: int) -> int:
    return flops.vocoder_bytes(_known(m), b, frames)
