"""gonova_tts_tpu_torch — the PyTorch/CUDA port of gonova_tts_tpu for NVIDIA Hopper.

The JAX package beside it is the reference: every module here mirrors one there
(same names, same parameter layouts) and is parity-tested against it on the CPU.
The two Pallas kernels on the text → PCM path are hand-written CUDA kernels in
`csrc/`, built with nvcc at first use (`ops/_build.py`).
"""

from .config import Config, load_config
from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["Config", "load_config", "resolve_device", "__version__"]
