"""The bigvgan family: the nova family's acoustic model (with a head of the
vocoder's `n_mels` bands) and speaker encoder (at `speaker_n_mels` bands), with
BigVGAN-v2's generator (`vocoder_family` "bigvgan", `models/bigvgan.py` of the port)
as the vocoder. Its plain reference is reference/bigvgan.py inside check.Judge; the
acoustic half of its counts is flops.py's, the generator's is counted here.

Operations (2 per multiply-add of every conv, as flops.py counts) and, for each
anti-aliased Snake-beta, SNAKE_OPS per channel-sample: 24 for the x2 upsampling (12
taps on each of two samples), 10 for Snake-beta, 24 for the x2 downsampling. Bytes as
nova counts a vocoder: the mel in, the f32 waveform out, the weights in bf16. An
activation alone reads and writes its [B, T, C] in bf16 and its f32 alpha and 1 / beta
(`snake_bytes`); its math runs on the CUDA cores, held against PEAK_F32.
"""

from __future__ import annotations

from typing import List, Tuple

from tts_bench import check, flops
from tts_bench.reference import bigvgan as reference

VOCODERS = ("bigvgan",)
VOCODER_FORWARDS = ("bigvgan",)
SNAKE_OPS = 58
PEAK_F32 = 67e12  # NVIDIA H100 SXM data sheet, f32 off the tensor cores


def _known(m: dict) -> dict:
    if m["vocoder_family"] not in VOCODERS:
        raise ValueError(f"the bigvgan family has no vocoder {m['vocoder_family']!r}")
    return m


class Judge(check.Judge):
    """check.Judge with reference/bigvgan.py's Reference."""

    def __init__(self, model: dict, engine: dict, checkpoint: str, device, numerics: str = "fp32"):
        super().__init__(_known(model), engine, checkpoint, device, numerics)
        self.ref = reference.Reference(self.ref.tree, self.s, device, self.ref.num)


def judge(model: dict, engine: dict, checkpoint: str, device, numerics: str = "fp32") -> Judge:
    return Judge(model, engine, checkpoint, device, numerics)


def pass_ops(m: dict, key: tuple) -> int:
    """("enc", B, L): the token half; ("dec", B, L, T): the frame half and the
    vocoder, with local attention as the one-graph length decides it."""
    if key[0] == "enc":
        return flops.encode(m, key[1], key[2])
    _, b, length, frames = key
    local = length * m["max_frames_per_token"] >= m["local_attention_min_frames"]
    return flops.decode(m, b, frames, local) + vocoder_ops(m, b, frames)


def _stages(m: dict, frames: int):
    """(C_in, C_out, kernel, samples a row after the stage's upsampling) of each stage."""
    ch, t = m["upsample_initial_channel"], frames
    for i, (rate, k) in enumerate(zip(m["upsample_rates"], m["upsample_kernels"])):
        t *= rate
        yield ch // 2**i, ch // 2 ** (i + 1), k, t


def snake_shapes(m: dict, b: int, frames: int) -> List[Tuple[int, int, int]]:
    """(B, C, T) of every anti-aliased activation of one forward, in order: those of the
    AMP blocks of each stage, then `act_post` at the last stage's shape."""
    per_stage = 2 * sum(len(rd) for rd in _known(m)["resblock_dilations"])
    out = []
    for _, c, _, t in _stages(m, frames):
        out += [(b, c, t)] * per_stage
    return out + out[-1:]


def snake_ops(b: int, c: int, t: int) -> int:
    return SNAKE_OPS * b * c * t


def snake_bytes(b: int, c: int, t: int) -> int:
    return 2 * 2 * b * c * t + 8 * c


def snake_least_seconds(m: dict, b: int, frames: int) -> float:
    """The activations' least time in one forward: each at max(operations / the f32
    peak, bytes / HBM bandwidth)."""
    return sum(flops.least_seconds(snake_ops(*s), snake_bytes(*s), PEAK_F32) for s in snake_shapes(m, b, frames))


def conv_ops(m: dict, b: int, frames: int) -> int:
    total = flops.conv1d(b, frames, 7, m["n_mels"], m["upsample_initial_channel"])
    t_in = frames
    for cin, cout, k, t in _stages(_known(m), frames):
        total += flops.conv_transpose1d(b, t_in, k, cin, cout)
        for rk, rd in zip(m["resblock_kernels"], m["resblock_dilations"]):
            total += 2 * len(rd) * flops.conv1d(b, t, rk, cout, cout)
        t_in = t
    last = m["upsample_initial_channel"] // 2 ** len(m["upsample_rates"])
    return total + flops.conv1d(b, t_in, 7, last, 1)


def vocoder_ops(m: dict, b: int, frames: int) -> int:
    return conv_ops(m, b, frames) + sum(snake_ops(*s) for s in snake_shapes(m, b, frames))


def vocoder_params(m: dict) -> int:
    ch = _known(m)["upsample_initial_channel"]
    n = 7 * m["n_mels"] * ch + ch
    for cin, cout, k, _ in _stages(m, 1):
        n += k * cin * cout + cout
        for rk, rd in zip(m["resblock_kernels"], m["resblock_dilations"]):
            n += 2 * len(rd) * (rk * cout * cout + cout) + 2 * len(rd) * 2 * cout
    last = ch // 2 ** len(m["upsample_rates"])
    return n + 2 * last + 7 * last


def vocoder_bytes(m: dict, b: int, frames: int, act_bytes: int = 2) -> int:
    """The mel in, the f32 waveform out, and the weights in the served dtype."""
    return b * frames * m["n_mels"] * act_bytes + 4 * b * frames * m["hop_length"] + act_bytes * vocoder_params(m)
