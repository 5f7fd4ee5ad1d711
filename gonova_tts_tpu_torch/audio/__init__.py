"""DSP helpers the port needs (the iSTFT bases of the vocoder head)."""

from .stft import hann_window, idft_bases

__all__ = ["hann_window", "idft_bases"]
