"""The port's stream encoders and overlap-add helpers against the JAX package's.

`gonova_tts_tpu_torch/audio/encode.py` is the port's copy of
`gonova_tts_tpu/audio/encode.py`: on the same PCM both must give the same bytes (pcm,
wav, and mp3/opus where this host has libmp3lame/libopus; those cases skip as
tests/test_encode.py skips them). `audio/ola.py`'s `stitch` and `crossfade_pair` are
held against `gonova_tts_tpu.audio.ola` within 1e-6.
"""

import numpy as np
import pytest
import torch

from gonova_tts_tpu.audio import encode as jenc
from gonova_tts_tpu.audio import ola as jola
from gonova_tts_tpu_torch.audio import crossfade_pair, hann_fade, stitch
from gonova_tts_tpu_torch.audio import encode as enc

SR = 24000


def pcm(seed: int, n: int) -> np.ndarray:
    """float32 PCM that is exact in int16: k / 32768 for int16 k."""
    k = np.random.default_rng(seed).integers(-20000, 20000, n).astype(np.int16)
    return k.astype(np.float32) / 32768.0


def encoded(mod, fmt: str, chunks, sample_rate: int = SR) -> bytes:
    e = mod.make_encoder(fmt, sample_rate, mp3_bitrate=128, opus_bitrate=48)
    return b"".join(e.encode(c) for c in chunks) + e.flush()


def need(fmt: str) -> None:
    if fmt not in jenc.available_formats():
        pytest.skip(f"no codec library for {fmt} on this host")


@pytest.mark.parametrize("fmt", ["pcm", "wav", "mp3", "opus"])
@pytest.mark.parametrize("n_chunks", [1, 7])
def test_stream_bytes_equal_the_jax_encoders(fmt, n_chunks):
    need(fmt)
    x = pcm(n_chunks, 12345)
    chunks = np.array_split(x, n_chunks)
    ours, theirs = encoded(enc, fmt, chunks), encoded(jenc, fmt, chunks)
    assert len(ours) > 0 and ours == theirs


@pytest.mark.parametrize("fmt", ["wav", "mp3", "opus"])
def test_int16_input_and_empty_stream_equal(fmt):
    """int16 input is taken as is; a stream with no audio still frames the same."""
    need(fmt)
    k = np.random.default_rng(5).integers(-30000, 30000, 4800).astype(np.int16)
    assert encoded(enc, fmt, [k]) == encoded(jenc, fmt, [k])
    assert encoded(enc, fmt, []) == encoded(jenc, fmt, [])


def test_ogg_crc_table_equal():
    assert enc._OGG_CRC_TABLE == jenc._OGG_CRC_TABLE
    page = bytes(range(256)) * 3
    assert enc._ogg_crc(page) == jenc._ogg_crc(page)


@pytest.mark.parametrize("sample_rate", [16000, 22050, 24000, 48000])
def test_available_formats_equal(sample_rate):
    assert enc.available_formats(sample_rate) == jenc.available_formats(sample_rate)
    for fmt in ("pcm", "wav", "mp3", "opus", "flac"):
        assert enc.probe_format(fmt, sample_rate) == jenc.probe_format(fmt, sample_rate)


def test_content_types_and_unknown_format():
    for fmt in ("pcm", "wav", "mp3", "opus", "flac"):
        assert enc.content_type(fmt) == jenc.content_type(fmt)
    assert enc.available_formats() == jenc.available_formats()
    with pytest.raises(enc.EncoderUnavailable, match="supported"):
        enc.make_encoder("flac", SR)


def test_encode_after_flush_raises():
    for fmt in ("mp3", "opus"):
        if fmt not in enc.available_formats():
            continue
        e = enc.make_encoder(fmt, SR)
        e.encode(pcm(0, 2400))
        e.flush()
        with pytest.raises(RuntimeError):
            e.encode(pcm(0, 2400))


@pytest.mark.parametrize("overlap", [0, 1, 64, 100000])
def test_stitch_matches_jax(overlap):
    rng = np.random.default_rng(overlap)
    clips = [rng.standard_normal(n).astype(np.float32) for n in (500, 0, 37, 1200)]
    ours, theirs = stitch(clips, overlap), jola.stitch(clips, overlap)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=0)
    assert stitch([]).shape == (0,)


@pytest.mark.parametrize("overlap", [0, 1, 48, 300])
def test_crossfade_pair_matches_jax(overlap):
    rng = np.random.default_rng(overlap + 1)
    a = rng.standard_normal((2, 400)).astype(np.float32)
    b = rng.standard_normal((2, 300)).astype(np.float32)
    ours = crossfade_pair(torch.as_tensor(a), torch.as_tensor(b), overlap)
    theirs = np.asarray(jola.crossfade_pair(a, b, overlap))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-6, rtol=0)


def test_hann_fade_matches_jax():
    for n in (1, 2, 257):
        np.testing.assert_array_equal(hann_fade(n), jola.hann_fade(n))
