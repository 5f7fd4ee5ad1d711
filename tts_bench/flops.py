"""Operations and bytes of the served model's passes, from their shapes, and the
card's peaks they are held against.

Operations count the products and convolutions (2 per multiply-add), as PyTorch's
FlopCounterMode counts the plain path; elementwise work, norms and softmax are left
out. A pass is counted at the shape it ran at (padding included). Bytes count each
input and output of a call once: weights in the served dtype, activations as they
enter and leave.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: bf16 tensor cores; split TF32 (three TF32
# products per f32-grade product: 495 / 3), the mel kernel's route; HBM3.
PEAK_BF16 = 989e12
PEAK_TF32_SPLIT = 495e12 / 3
PEAK_BYTES = 3.35e12


def linear(rows: int, k: int, n: int) -> int:
    return 2 * rows * k * n


def conv1d(b: int, t_out: int, k: int, cin: int, cout: int, groups: int = 1) -> int:
    return 2 * b * t_out * k * (cin // groups) * cout


def conv_transpose1d(b: int, t_in: int, k: int, cin: int, cout: int) -> int:
    """Each input sample meets k taps for every pair of channels."""
    return 2 * b * t_in * k * cin * cout


def attention(b: int, t: int, d: int, window=None) -> int:
    """Logits and the weighted sum over `t` queries of width d (all heads): each
    query meets t keys, or 3 * window in blocked local attention."""
    keys = t if window is None else 3 * window
    return 2 * 2 * b * t * keys * d


def transformer(m: dict, b: int, t: int, layers: int, window=None) -> int:
    d, f, k = m["d_model"], m["d_ff"], m["conv_kernel"]
    per = linear(b * t, d, d) * 4 + attention(b, t, d, window) + conv1d(b, t, k, d, f) + conv1d(b, t, k, f, d)
    return layers * per


def encode(m: dict, b: int, length: int) -> int:
    """Token half: speaker projection, encoder, both predictors, pitch embedding."""
    d, hid = m["d_model"], 256
    pred = conv1d(b, length, 3, d, hid) + conv1d(b, length, 3, hid, hid) + linear(b * length, hid, 1)
    return (linear(b, m["speaker_dim"], d) + transformer(m, b, length, m["encoder_layers"])
            + 2 * pred + linear(b * length, 1, d))


def decode(m: dict, b: int, frames: int, local: bool) -> int:
    """Frame half: decoder and the mel projection."""
    window = m["decoder_attention_window"] if local and 2 * m["decoder_attention_window"] < frames else None
    return transformer(m, b, frames, m["decoder_layers"], window) + linear(b * frames, m["d_model"], m["n_mels"])


def vocos(m: dict, b: int, frames: int) -> int:
    c, f, n_bins = m["vocos_dim"], m["vocos_ff"], m["n_fft"] // 2 + 1
    head = (3 if m["vocos_head"] == "cartesian" else 2) * n_bins
    block = conv1d(b, frames, 7, c, c, groups=c) + linear(b * frames, c, f) + linear(b * frames, f, c)
    return (conv1d(b, frames, 7, m["n_mels"], c) + m["vocos_layers"] * block + linear(b * frames, c, head)
            + linear(b * frames, 2 * n_bins, m["n_fft"]))  # the inverse DFT as a product


def hifigan(m: dict, b: int, frames: int) -> int:
    ch, t = m["upsample_initial_channel"], frames
    total = conv1d(b, t, 7, m["n_mels"], ch)
    for i, (rate, k) in enumerate(zip(m["upsample_rates"], m["upsample_kernels"])):
        cin, cout = ch // 2**i, ch // 2 ** (i + 1)
        total += conv_transpose1d(b, t, k, cin, cout)
        t *= rate
        for rk, rd in zip(m["resblock_kernels"], m["resblock_dilations"]):
            total += 2 * len(rd) * conv1d(b, t, rk, cout, cout)
    return total + conv1d(b, t, 7, ch // 2 ** len(m["upsample_rates"]), 1)


def vocoder(m: dict, b: int, frames: int) -> int:
    return (hifigan if m["vocoder_family"] == "hifigan" else vocos)(m, b, frames)


def vocoder_params(m: dict) -> int:
    if m["vocoder_family"] == "hifigan":
        ch = m["upsample_initial_channel"]
        n = 7 * m["n_mels"] * ch + ch
        for i, k in enumerate(m["upsample_kernels"]):
            cin, cout = ch // 2**i, ch // 2 ** (i + 1)
            n += k * cin * cout + cout
            n += sum(2 * len(rd) * (rk * cout * cout + cout) for rk, rd in zip(m["resblock_kernels"], m["resblock_dilations"]))
        return n + 7 * (ch // 2 ** len(m["upsample_rates"])) + 1
    c, f, n_bins = m["vocos_dim"], m["vocos_ff"], m["n_fft"] // 2 + 1
    head = (3 if m["vocos_head"] == "cartesian" else 2) * n_bins
    block = 7 * c + c + c + 2 * c + c * f + f + f * c + c
    return 7 * m["n_mels"] * c + c + m["vocos_layers"] * block + 2 * c + c * head + head


def vocoder_bytes(m: dict, b: int, frames: int, act_bytes: int = 2) -> int:
    """The mel in, the f32 waveform out, and the weights in the served dtype."""
    return b * frames * m["n_mels"] * act_bytes + 4 * b * frames * m["hop_length"] + act_bytes * vocoder_params(m)


def pass_flops(m: dict, b: int, length: int, frames: int) -> int:
    """A two-stage pass: the token half at `length`, the frame half and the vocoder
    at `frames` (local attention as the one-graph length decides it)."""
    local = length * m["max_frames_per_token"] >= m["local_attention_min_frames"]
    return encode(m, b, length) + decode(m, b, frames, local) + vocoder(m, b, frames)


def least_seconds(ops: float, nbytes: float, peak_ops: float) -> float:
    return max(ops / peak_ops, nbytes / PEAK_BYTES)


def mel_kernel(frames: int, n_fft: int, n_mels: int, in_bytes: int, out_bytes: int):
    """(operations, bytes) of the fused log-mel: two real DFT products over the
    frames and the filterbank product; the signal in, the mel out, the f32 bases and
    filterbank read once."""
    n_bins = n_fft // 2 + 1
    ops = frames * (2 * 2 * n_fft * n_bins + 2 * n_bins * n_mels)
    moved = in_bytes + out_bytes + 4 * (2 * n_fft * n_bins + n_bins * n_mels)
    return ops, moved

