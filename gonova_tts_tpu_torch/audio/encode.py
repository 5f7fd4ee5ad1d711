"""Streaming audio encoders: MP3 (libmp3lame), Ogg Opus (libopus + pure-Python Ogg
muxer), and WAV framing.

The port's own copy of `gonova_tts_tpu/audio/encode.py` (numpy and ctypes only): the
same bytes for the same PCM, so a client of either service decodes the same stream.
The Opus vendor string keeps the JAX package's name for that reason.

Implements the reference's promised `encoding:` config section
(reference services/tts/README.md:296-300 — default_format pcm|wav|mp3|opus,
mp3_bitrate, opus_bitrate).  The reference never shipped the feature; this module
does, as host-side ctypes bindings over the system codecs (no Python codec packages
exist in the image, and the compute path never touches this — encoding happens on
the host after the int16 PCM leaves the device).

All encoders are *streaming*: construct once per request, feed PCM chunks as the
engine yields them, emit whatever encoded bytes are ready, and flush() at
end-of-stream.  This is what the WS binary-frame path needs — no buffering of the
whole utterance.

Availability is probed lazily: `available_formats()` reports what the host can do,
and constructing an encoder whose library is missing raises EncoderUnavailable
(the service turns that into a protocol error frame listing supported formats).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import List, Optional

import numpy as np

__all__ = [
    "EncoderUnavailable",
    "Mp3Encoder",
    "OpusEncoder",
    "WavStreamEncoder",
    "PcmEncoder",
    "available_formats",
    "make_encoder",
    "content_type",
]


class EncoderUnavailable(RuntimeError):
    """The codec library for the requested format is not present on this host."""


def _load(names: List[str]) -> Optional[ctypes.CDLL]:
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    found = ctypes.util.find_library(names[0].split(".")[0].replace("lib", ""))
    if found:
        try:
            return ctypes.CDLL(found)
        except OSError:
            return None
    return None


_lame: Optional[ctypes.CDLL] = None
_lame_tried = False
_opus: Optional[ctypes.CDLL] = None
_opus_tried = False


def _get_lame() -> Optional[ctypes.CDLL]:
    global _lame, _lame_tried
    if not _lame_tried:
        _lame_tried = True
        _lame = _load(["libmp3lame.so.0", "libmp3lame.so", "libmp3lame.dylib"])
        if _lame is not None:
            _lame.lame_init.restype = ctypes.c_void_p
            for fn in (
                "lame_set_num_channels",
                "lame_set_in_samplerate",
                "lame_set_brate",
                "lame_set_mode",
                "lame_set_quality",
            ):
                getattr(_lame, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
            _lame.lame_init_params.argtypes = [ctypes.c_void_p]
            _lame.lame_encode_buffer.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int,
                ctypes.c_void_p,
                ctypes.c_int,
            ]
            _lame.lame_encode_flush.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int,
            ]
            _lame.lame_close.argtypes = [ctypes.c_void_p]
    return _lame


def _get_opus() -> Optional[ctypes.CDLL]:
    global _opus, _opus_tried
    if not _opus_tried:
        _opus_tried = True
        _opus = _load(["libopus.so.0", "libopus.so", "libopus.dylib"])
        if _opus is not None:
            _opus.opus_encoder_create.restype = ctypes.c_void_p
            _opus.opus_encoder_create.argtypes = [
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            _opus.opus_encode.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int,
                ctypes.c_void_p,
                ctypes.c_int,
            ]
            _opus.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
            # opus_encoder_ctl is variadic; declaring the fixed-arg prefix is
            # REQUIRED — without argtypes ctypes passes the encoder pointer as a
            # 32-bit int, which segfaults once the heap sits above 4 GB (bit us
            # in the full-service process). Varargs are passed as ctypes objects.
            _opus.opus_encoder_ctl.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return _opus


def _as_int16(pcm: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] or int16 → contiguous int16 (same convention as the engine's
    device-side PCM16 pack, engine/engine.py)."""
    pcm = np.asarray(pcm)
    if pcm.dtype == np.int16:
        return np.ascontiguousarray(pcm)
    return np.ascontiguousarray(
        np.clip(pcm.astype(np.float32) * 32767.0, -32767.0, 32767.0).astype(np.int16)
    )


# --------------------------------------------------------------------------- MP3


class Mp3Encoder:
    """Streaming MP3 via libmp3lame (CBR, mono)."""

    format = "mp3"

    def __init__(self, sample_rate: int, bitrate_kbps: int = 192):
        lib = _get_lame()
        if lib is None:
            raise EncoderUnavailable("mp3: libmp3lame not found on this host")
        self._lib = lib
        gfp = lib.lame_init()
        if not gfp:
            raise EncoderUnavailable("mp3: lame_init failed")
        self._gfp = gfp
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_brate(gfp, int(bitrate_kbps))
        lib.lame_set_mode(gfp, 3)  # MONO
        lib.lame_set_quality(gfp, 2)  # high-quality psychoacoustics
        if lib.lame_init_params(gfp) < 0:
            lib.lame_close(gfp)
            self._gfp = None
            raise EncoderUnavailable(
                f"mp3: lame rejected sample_rate={sample_rate} bitrate={bitrate_kbps}"
            )

    def encode(self, pcm: np.ndarray) -> bytes:
        if self._gfp is None:
            # Calling into lame with a NULL handle would SIGSEGV the process.
            raise RuntimeError("mp3: encoder already flushed")
        pcm = _as_int16(pcm)
        n = len(pcm)
        if n == 0:
            return b""
        out = ctypes.create_string_buffer(n + n // 4 + 7200)  # lame's documented bound
        written = self._lib.lame_encode_buffer(
            self._gfp,
            pcm.ctypes.data_as(ctypes.c_void_p),
            pcm.ctypes.data_as(ctypes.c_void_p),  # right channel ignored in mono
            n,
            out,
            len(out),
        )
        if written < 0:
            raise RuntimeError(f"mp3: lame_encode_buffer error {written}")
        return out.raw[:written]

    def flush(self) -> bytes:
        if self._gfp is None:
            return b""
        out = ctypes.create_string_buffer(7200)
        written = self._lib.lame_encode_flush(self._gfp, out, len(out))
        self._lib.lame_close(self._gfp)
        self._gfp = None
        return out.raw[: max(written, 0)]

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            if getattr(self, "_gfp", None):
                self._lib.lame_close(self._gfp)
                self._gfp = None
        except Exception:
            pass


# ---------------------------------------------------------------------- Ogg Opus

# Ogg page CRC: 32-bit, poly 0x04c11db7, init 0, not reflected, no final xor
# (RFC 3533 §6). Table built once.
def _build_ogg_crc_table() -> list:
    table = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) if (r & 0x80000000) else (r << 1)
        table.append(r & 0xFFFFFFFF)
    return table


# Built eagerly at import: a lazy `if not table: append` is racy under concurrent
# first encodes (two threads interleaving appends would corrupt every CRC after).
_OGG_CRC_TABLE = _build_ogg_crc_table()


def _ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _OGG_CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


def _ogg_page(
    serial: int,
    seq: int,
    granule: int,
    packet: bytes,
    header_type: int,
) -> bytes:
    """One Ogg page carrying one whole packet (RFC 3533). Packets here are always
    < 255*255 bytes (Opus frames at speech bitrates are ~100-400 B), so no
    continuation pages are needed; the lacing table is 255-chunks + terminator."""
    n_full, rem = divmod(len(packet), 255)
    lacing = bytes([255] * n_full + [rem])
    header = struct.pack(
        "<4sBBqIIIB",
        b"OggS",
        0,
        header_type,
        granule,
        serial,
        seq,
        0,  # CRC placeholder
        len(lacing),
    ) + lacing
    crc = _ogg_crc(header + packet)
    header = header[:22] + struct.pack("<I", crc) + header[26:]
    return header + packet


class OpusEncoder:
    """Streaming Ogg Opus via libopus + a pure-Python Ogg muxer (RFC 7845).

    Opus frames are 20 ms; input PCM is buffered to frame boundaries and the final
    partial frame is zero-padded with the end granule position trimmed per RFC 7845
    §4.5 so decoders reconstruct the exact sample count. Granule positions are
    always in 48 kHz units regardless of the input rate."""

    format = "opus"
    FRAME_MS = 20
    _APPLICATION_AUDIO = 2049
    _SET_BITRATE = 4002
    _GET_LOOKAHEAD = 4027

    def __init__(self, sample_rate: int, bitrate_kbps: int = 64, serial: int = 0x6E6F7661):
        lib = _get_opus()
        if lib is None:
            raise EncoderUnavailable("opus: libopus not found on this host")
        if sample_rate not in (8000, 12000, 16000, 24000, 48000):
            raise EncoderUnavailable(f"opus: unsupported sample rate {sample_rate}")
        self._lib = lib
        err = ctypes.c_int(0)
        self._enc = lib.opus_encoder_create(
            sample_rate, 1, self._APPLICATION_AUDIO, ctypes.byref(err)
        )
        if err.value != 0 or not self._enc:
            raise EncoderUnavailable(f"opus: opus_encoder_create error {err.value}")
        lib.opus_encoder_ctl(self._enc, self._SET_BITRATE, ctypes.c_int(bitrate_kbps * 1000))
        look = ctypes.c_int(0)
        lib.opus_encoder_ctl(self._enc, self._GET_LOOKAHEAD, ctypes.byref(look))
        self._sr = sample_rate
        self._frame = sample_rate * self.FRAME_MS // 1000
        self._g_per_frame = 48000 * self.FRAME_MS // 1000
        # Pre-skip in 48 kHz units (RFC 7845 §5.1): the encoder's algorithmic delay.
        self._preskip48 = look.value * (48000 // sample_rate)
        self._buf = np.zeros((0,), np.int16)
        self._granule = 0  # end-granule of the last emitted frame (48 kHz units)
        self._in_samples = 0  # total input samples accepted
        self._serial = serial
        self._seq = 0
        self._header: Optional[bytes] = None

    def _headers(self) -> bytes:
        head = (
            b"OpusHead"
            + struct.pack("<BBHIhB", 1, 1, self._preskip48, self._sr, 0, 0)
        )
        vendor = b"gonova-tts-tpu"
        tags = b"OpusTags" + struct.pack("<I", len(vendor)) + vendor + struct.pack("<I", 0)
        p0 = _ogg_page(self._serial, 0, 0, head, 0x02)  # BOS
        p1 = _ogg_page(self._serial, 1, 0, tags, 0x00)
        self._seq = 2
        return p0 + p1

    def _encode_frame(self, frame: np.ndarray) -> bytes:
        out = ctypes.create_string_buffer(4000)  # recommended max packet size
        n = self._lib.opus_encode(
            self._enc,
            np.ascontiguousarray(frame).ctypes.data_as(ctypes.c_void_p),
            len(frame),
            out,
            len(out),
        )
        if n < 0:
            raise RuntimeError(f"opus: opus_encode error {n}")
        return out.raw[:n]

    def encode(self, pcm: np.ndarray) -> bytes:
        if self._enc is None:
            raise RuntimeError("opus: encoder already flushed")
        pcm = _as_int16(pcm)
        self._in_samples += len(pcm)
        # COPY when adopting the caller's array: a reused/refilled input buffer
        # must not mutate samples still queued for the next frame boundary.
        self._buf = (
            np.concatenate([self._buf, pcm]) if len(self._buf) else pcm.copy()
        )
        chunks = []
        if self._header is None:
            self._header = self._headers()
            chunks.append(self._header)
        while len(self._buf) >= self._frame:
            frame, self._buf = self._buf[: self._frame], self._buf[self._frame :]
            pkt = self._encode_frame(frame)
            self._granule += self._g_per_frame
            # RFC 7845 §4: page granule = cumulative decoded sample count at
            # 48 kHz (pre-skip included in the count, playback = granule - preskip).
            chunks.append(_ogg_page(self._serial, self._seq, self._granule, pkt, 0x00))
            self._seq += 1
        return b"".join(chunks)

    def flush(self) -> bytes:
        if self._enc is None:
            return b""
        chunks = []
        if self._header is None:  # zero-length stream still needs valid headers
            self._header = self._headers()
            chunks.append(self._header)
        # Final frame: zero-pad the partial remainder (or emit one silence frame —
        # Ogg packets must not be empty, RFC 7845 §3) and set the EOS page's
        # granule to the true end so the padding is trimmed on decode (§4.5).
        # §4.5 also requires the EOS granule not to exceed the decodable total:
        # when the remainder carries more real audio than (frame - preskip),
        # pre-skip trimming would eat into it, so emit extra fully-trimmed
        # silence frames until enough decoded samples exist past the true end.
        true_end48 = self._preskip48 + self._in_samples * (48000 // self._sr)
        frame = np.zeros((self._frame,), np.int16)
        if len(self._buf) > 0:
            frame[: len(self._buf)] = self._buf
            self._buf = self._buf[:0]
        pkt = self._encode_frame(frame)
        self._granule += self._g_per_frame
        while self._granule < true_end48:
            chunks.append(_ogg_page(self._serial, self._seq, self._granule, pkt, 0x00))
            self._seq += 1
            pkt = self._encode_frame(np.zeros((self._frame,), np.int16))
            self._granule += self._g_per_frame
        chunks.append(_ogg_page(self._serial, self._seq, true_end48, pkt, 0x04))
        self._seq += 1
        self._lib.opus_encoder_destroy(self._enc)
        self._enc = None
        return b"".join(chunks)

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            if getattr(self, "_enc", None):
                self._lib.opus_encoder_destroy(self._enc)
                self._enc = None
        except Exception:
            pass


# ----------------------------------------------------------------- WAV / PCM


class WavStreamEncoder:
    """Streaming WAV (PCM16 mono): RIFF header first with the unknown-size
    convention (0xFFFFFFFF chunk sizes — the standard for live WAV streams), then
    raw PCM16. A non-streaming caller that wants exact sizes should assemble the
    PCM and use utils.write_wav instead."""

    format = "wav"

    def __init__(self, sample_rate: int):
        self._sr = int(sample_rate)
        self._header_sent = False

    def _header(self) -> bytes:
        byte_rate = self._sr * 2
        return (
            b"RIFF"
            + struct.pack("<I", 0xFFFFFFFF)
            + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, self._sr, byte_rate, 2, 16)
            + b"data"
            + struct.pack("<I", 0xFFFFFFFF)
        )

    def encode(self, pcm: np.ndarray) -> bytes:
        out = b"" if self._header_sent else self._header()
        self._header_sent = True
        return out + _as_int16(pcm).tobytes()

    def flush(self) -> bytes:
        if not self._header_sent:
            self._header_sent = True
            return self._header()
        return b""


class PcmEncoder:
    """Identity framing: raw float32 PCM — the wire default, byte-compatible with
    the reference protocol (SURVEY.md §2.3 binary frames)."""

    format = "pcm"

    def __init__(self, sample_rate: int):
        del sample_rate

    def encode(self, pcm: np.ndarray) -> bytes:
        return np.asarray(pcm, np.float32).tobytes()

    def flush(self) -> bytes:
        return b""


# ------------------------------------------------------------------- factory

_CONTENT_TYPES = {
    "pcm": "application/octet-stream",
    "wav": "audio/wav",
    "mp3": "audio/mpeg",
    "opus": "audio/ogg",
}


def content_type(fmt: str) -> str:
    return _CONTENT_TYPES.get(fmt, "application/octet-stream")


def available_formats(
    sample_rate: Optional[int] = None,
    mp3_bitrate: int = 192,
    opus_bitrate: int = 64,
) -> List[str]:
    """Formats this host can actually produce (pcm/wav always; mp3/opus when the
    system codec library loads). With `sample_rate` given, also drop formats whose
    codec rejects that rate/bitrate combo (opus accepts only 8/12/16/24/48 kHz;
    lame rejects non-MPEG rates) — so admission-time checks agree exactly with
    synthesis-time encoder construction instead of 500ing after a full synthesis."""
    fmts = ["pcm", "wav"]
    for fmt in ("mp3", "opus"):
        if sample_rate is None:
            if (_get_lame() if fmt == "mp3" else _get_opus()) is not None:
                fmts.append(fmt)
        elif (
            probe_format(
                fmt, sample_rate, mp3_bitrate=mp3_bitrate, opus_bitrate=opus_bitrate
            )
            is None
        ):
            fmts.append(fmt)
    return fmts


def probe_format(
    fmt: str,
    sample_rate: int,
    mp3_bitrate: int = 192,
    opus_bitrate: int = 64,
) -> Optional[str]:
    """Return None when make_encoder(fmt, sample_rate, ...) would succeed, else the
    failure reason. Constructs (and immediately releases) a real encoder, so the
    check is exact for any codec-internal rate/bitrate constraint."""
    try:
        enc = make_encoder(
            fmt, sample_rate, mp3_bitrate=mp3_bitrate, opus_bitrate=opus_bitrate
        )
    except EncoderUnavailable as exc:
        return str(exc)
    try:
        enc.flush()  # releases native state (lame_close / opus_encoder_destroy)
    except Exception:
        pass
    return None


def make_encoder(fmt: str, sample_rate: int, mp3_bitrate: int = 192, opus_bitrate: int = 64):
    """One streaming encoder per synthesis request. Raises EncoderUnavailable for
    unknown formats or missing host codecs."""
    fmt = (fmt or "pcm").lower()
    if fmt == "pcm":
        return PcmEncoder(sample_rate)
    if fmt == "wav":
        return WavStreamEncoder(sample_rate)
    if fmt == "mp3":
        return Mp3Encoder(sample_rate, mp3_bitrate)
    if fmt == "opus":
        return OpusEncoder(sample_rate, opus_bitrate)
    raise EncoderUnavailable(
        f"unknown format {fmt!r}; supported: {', '.join(available_formats())}"
    )
