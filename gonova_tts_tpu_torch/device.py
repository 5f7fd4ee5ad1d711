"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU (as the tests do);
asking for CUDA where there is none raises instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means CUDA. On CUDA this also pins full-f32 matmuls and convolutions:
    cuDNN convolutions default to TF32, whose error is above the PCM16 LSB."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
