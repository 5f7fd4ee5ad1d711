"""In-repo RIFF/WAVE codec.

The reference service reads voice uploads with ``soundfile`` and writes temp WAVs with
``torchaudio.save`` (reference: services/tts/core/voice_manager.py:110,
services/tts/core/synthesizer.py:402).  Neither library is a dependency here, and the
formats we need are trivial: PCM 16/24/32-bit and IEEE float32/64, mono or multichannel.
This module implements both directions with numpy only.

Reads return float64 in [-1, 1] for integer PCM (matching libsndfile's convention of
dividing by 2**(bits-1)) so the reference's validation thresholds
(voice_manager.py:208-240) apply unchanged.
"""

from __future__ import annotations

import io
import struct
from typing import Tuple, Union

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavError(ValueError):
    """Raised for malformed or unsupported WAV payloads."""


def read_wav(data: Union[bytes, str]) -> Tuple[np.ndarray, int]:
    """Decode a WAV file.

    Args:
      data: raw RIFF bytes, or a filesystem path.

    Returns:
      (audio, sample_rate). ``audio`` is float64, shape [n] for mono or [n, channels],
      scaled to [-1, 1] for integer PCM (float files are returned as stored).
    """
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    buf = memoryview(data)
    if len(buf) < 12 or bytes(buf[0:4]) != b"RIFF" or bytes(buf[8:12]) != b"WAVE":
        raise WavError("not a RIFF/WAVE file")

    fmt = None
    audio_raw = None
    pos = 12
    while pos + 8 <= len(buf):
        chunk_id = bytes(buf[pos : pos + 4])
        (chunk_size,) = struct.unpack_from("<I", buf, pos + 4)
        body_start = pos + 8
        body_end = min(body_start + chunk_size, len(buf))
        if chunk_id == b"fmt ":
            if chunk_size < 16:
                raise WavError("fmt chunk too small")
            if body_start + 16 > len(buf):
                raise WavError("truncated fmt chunk")
            fmt = struct.unpack_from("<HHIIHH", buf, body_start)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                if body_start + 26 > len(buf):
                    raise WavError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
                # SubFormat GUID's first two bytes carry the real format tag.
                (sub_tag,) = struct.unpack_from("<H", buf, body_start + 24)
                fmt = (sub_tag,) + fmt[1:]
        elif chunk_id == b"data":
            audio_raw = bytes(buf[body_start:body_end])
        # Chunks are word-aligned.
        pos = body_start + chunk_size + (chunk_size & 1)

    if fmt is None:
        raise WavError("missing fmt chunk")
    if audio_raw is None:
        raise WavError("missing data chunk")

    tag, channels, sample_rate, _byte_rate, _block_align, bits = fmt
    if channels < 1:
        raise WavError("invalid channel count")
    if sample_rate < 1:
        raise WavError("invalid sample rate")
    # A truncated data chunk may end mid-sample: trim to whole samples so
    # np.frombuffer never raises its generic buffer-size ValueError.
    if bits in (16, 32, 64):
        width = bits // 8
        audio_raw = audio_raw[: len(audio_raw) - len(audio_raw) % width]

    if tag == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(audio_raw, dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 32:
            x = np.frombuffer(audio_raw, dtype="<i4").astype(np.float64) / 2147483648.0
        elif bits == 8:
            # 8-bit WAV is unsigned.
            x = (np.frombuffer(audio_raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(audio_raw[: len(audio_raw) - len(audio_raw) % 3], dtype=np.uint8)
            raw = raw.reshape(-1, 3)
            as_int = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            as_int = np.where(as_int >= 1 << 23, as_int - (1 << 24), as_int)
            x = as_int.astype(np.float64) / 8388608.0
        else:
            raise WavError(f"unsupported PCM bit depth: {bits}")
    elif tag == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(audio_raw, dtype="<f4").astype(np.float64)
        elif bits == 64:
            x = np.frombuffer(audio_raw, dtype="<f8").astype(np.float64)
        else:
            raise WavError(f"unsupported float bit depth: {bits}")
    else:
        raise WavError(f"unsupported WAV format tag: 0x{tag:04x}")

    if channels > 1:
        x = x[: len(x) - len(x) % channels].reshape(-1, channels)
    return x, sample_rate


def write_wav(
    path_or_buf: Union[str, io.BufferedIOBase, None],
    audio: np.ndarray,
    sample_rate: int,
    dtype: str = "float32",
) -> bytes:
    """Encode audio to WAV. Returns the bytes; also writes to path/buf when given.

    dtype: 'float32' (IEEE float) or 'int16' (PCM). Input audio is interpreted as
    [-1, 1] floats regardless of target dtype.
    """
    audio = np.asarray(audio)
    if audio.ndim == 1:
        channels = 1
        frames = audio[:, None]
    elif audio.ndim == 2:
        channels = audio.shape[1]
        frames = audio
    else:
        raise WavError("audio must be 1-D or 2-D [n, channels]")

    if dtype == "float32":
        tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = frames.astype("<f4").tobytes()
    elif dtype == "int16":
        tag, bits = _WAVE_FORMAT_PCM, 16
        clipped = np.clip(frames, -1.0, 1.0)
        payload = (clipped * 32767.0).round().astype("<i2").tobytes()
    else:
        raise WavError(f"unsupported target dtype: {dtype}")
    if len(payload) + 36 > 0xFFFFFFFF or channels > 0xFFFF or sample_rate > 0xFFFFFFFF:
        # RIFF size fields are 32/16-bit; overflowing them used to escape as a
        # bare struct.error AFTER materializing the multi-GiB payload.
        raise WavError(
            f"WAV limits exceeded (payload {len(payload)} bytes, {channels} ch, "
            f"{sample_rate} Hz): RIFF caps at 4 GiB / 65535 channels"
        )

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    header = b"".join(
        [
            b"RIFF",
            struct.pack("<I", 36 + len(payload)),
            b"WAVE",
            b"fmt ",
            struct.pack("<IHHIIHH", 16, tag, channels, sample_rate, byte_rate, block_align, bits),
            b"data",
            struct.pack("<I", len(payload)),
        ]
    )
    out = header + payload
    if isinstance(path_or_buf, str):
        with open(path_or_buf, "wb") as f:
            f.write(out)
    elif path_or_buf is not None:
        path_or_buf.write(out)
    return out
