"""DSP ops of the port: STFT bases and framing, mel features, resampling."""

from .mel import mcd, mel_filterbank, mel_mse, mel_spectrogram
from .resample import resample, resample_np
from .stft import dft_bases, frame_signal, hann_window, idft_bases, spectrogram, stft_ri

__all__ = [
    "dft_bases",
    "frame_signal",
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
]
