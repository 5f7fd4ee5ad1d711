"""DSP ops of the port: STFT bases and framing, mel features, resampling, overlap-add.

`audio.encode` (the wav/mp3/opus stream encoders) is imported as a module, as in the
JAX package."""

from .mel import mcd, mel_filterbank, mel_mse, mel_spectrogram
from .ola import crossfade_pair, hann_fade, stitch
from .resample import resample, resample_np
from .stft import dft_bases, frame_signal, hann_window, idft_bases, spectrogram, stft_ri

__all__ = [
    "crossfade_pair",
    "dft_bases",
    "frame_signal",
    "hann_fade",
    "hann_window",
    "idft_bases",
    "mcd",
    "mel_filterbank",
    "mel_mse",
    "mel_spectrogram",
    "resample",
    "resample_np",
    "spectrogram",
    "stft_ri",
    "stitch",
]
