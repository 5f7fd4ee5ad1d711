"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

| wrapper | replaces (TPU Pallas kernel) | source |
|---|---|---|
| `transformer_stack.transformer_stack` | `gonova_tts_tpu/ops/transformer_stack_kernel.py` `transformer_stack_pallas` | `csrc/transformer_stack.cu` |
| `vocos_stack.vocos_stack` | `gonova_tts_tpu/ops/vocos_stack_kernel.py` `vocos_stack_pallas` | `csrc/vocos_stack.cu` |
| `mel_spectrogram.mel_spectrogram` | `gonova_tts_tpu/ops/mel_kernel.py` `mel_spectrogram_pallas` | `csrc/mel_spectrogram.cu` |
| `convnext_block.convnext_block` | `gonova_tts_tpu/ops/convnext_kernel.py` `convnext_block_pallas` | `csrc/convnext_block.cu` |
| `snake_aa.snake_aa` | none: BigVGAN-v2's anti-aliased Snake-beta, which the JAX package lacks | `csrc/snake_aa.cu` |

In bf16 the two stacks run their products through the tensor-core GEMM of
`csrc/gemm_tc.cuh`; `gemm_tc.gemm_tc` (`csrc/gemm_tc.cu`) is that GEMM alone, with its
planner and plain version: a part of those two kernels, not a fifth.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (built on first use by `_build.py`) or raises. Every launch
adds one to the wrapper's `LaunchCounter`, which is how a run shows that the
serving path went through the kernels. Two counters are no hand kernel's: they
count cuDNN convs of BigVGAN-v2's channels-last path, `conv_nwc` each of them
(`models/layers.conv1d_nwc`, `conv1d_transpose_nwc`, `conv1d_phased`) and
`conv_phased` those over the phases of a dilated conv's row.
"""

from __future__ import annotations

from typing import Dict


class LaunchCounter:
    """Number of kernel launches through one wrapper."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


_COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return _COUNTERS.setdefault(name, LaunchCounter(name))


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.count = 0
