"""Anti-aliased Snake-beta: hand-written CUDA kernel and its plain PyTorch version.

BigVGAN-v2's activation (`Activation1d(SnakeBeta)` of NVIDIA's BigVGAN, arXiv:2206.04658),
109 times in each forward of `models/bigvgan.py`. No TPU kernel stands behind it:
the JAX package has no BigVGAN. The kernel is `csrc/snake_aa.cu`; its source note
says what bounds it on the H100 (bytes) and what the design does about it (one read
and one write of x; the 2T-long upsampled signal stays in registers).

Per channel c of x [B, T, C], with the 12-tap low-pass `kaiser_sinc_filter()` f:

  * upsample x2: `2 * conv_transpose1d(replicate_pad(x, 5), f, stride 2)`, cropped
    by 15 at each end;
  * Snake-beta on the 2T samples: `a = u + 1 / (beta_c + 1e-9) * sin(alpha_c * u)^2`,
    alpha and beta the exponentials of the stored log-scale parameters;
  * downsample x2: `conv1d(replicate_pad(a, 5, 6), f, stride 2)`.

`snake_aa_plain` computes it in polyphase form, as the kernel does, with each pad an
index clamped to the signal (the downsampler's pad repeats the activated upsampled
edge sample, not the input's); math in f32, the result in x's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import counter

TAPS = 12
# Input samples each side that one output reads: the upsampler's phases read x[p-3 .. p+2]
# and x[p-2 .. p+3], the downsampler's output m the upsampled a[2m-5 .. 2m+6].
REACH = 5
_COUNT = counter("snake_aa")
# snake_aa_forward(dtype, B, C, T, x, y, alpha, inv_beta, taps, stream)
_SIGNATURE = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kaiser_sinc_filter(cutoff: float = 0.25, half_width: float = 0.3, kernel_size: int = TAPS) -> torch.Tensor:
    """BigVGAN's `kaiser_sinc_filter1d` for an even kernel, in float32 as it computes
    it: a Kaiser window (beta from the attenuation A = 2.285 (k/2 - 1) pi 4 w + 7.95)
    times 2 cutoff sinc(2 cutoff t) at t = -k/2 + 0.5 ... k/2 - 0.5, scaled to sum 1."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * (4 * half_width) + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    x = 2 * cutoff * (torch.arange(-half, half) + 0.5)
    sinc = torch.where(x == 0, torch.tensor(1.0), torch.sin(math.pi * x) / math.pi / x)
    taps = 2 * cutoff * window * sinc
    return taps / taps.sum()


@functools.lru_cache(maxsize=None)
def _taps_host() -> Tuple[torch.Tensor, ctypes.Array]:
    f = kaiser_sinc_filter()
    return f, (ctypes.c_float * TAPS)(*f.tolist())


def constants(log_alpha: torch.Tensor, log_beta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, 1 / (beta + 1e-9)) in f32 from the log-scale parameters."""
    return torch.exp(log_alpha.float()), 1.0 / (torch.exp(log_beta.float()) + 1e-9)


def snake_aa_plain(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor) -> torch.Tensor:
    f = _taps_host()[0].to(x.device)
    t = x.shape[1]
    xf = x.float()
    idx = torch.arange(t, device=x.device)

    def xs(shift):  # x[clamp(p + shift)] for every p
        return xf[:, torch.clamp(idx + shift, 0, t - 1)]

    even = sum(f[2 * i + 1] * xs(2 - i) for i in range(6))
    odd = sum(f[2 * i] * xs(3 - i) for i in range(6))
    u = 2.0 * torch.stack([even, odd], dim=2).reshape(x.shape[0], 2 * t, x.shape[2])
    a = u + inv_beta * torch.sin(u * alpha) ** 2
    n = torch.clamp(2 * idx[:, None] + torch.arange(TAPS, device=x.device)[None] - 5, 0, 2 * t - 1)  # [T, 12]
    y = (a[:, n] * f[:, None]).sum(dim=2)
    return y.to(x.dtype)


def snake_aa(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] (f32 or bf16) → the activation, [B, T, C] in x's dtype; `alpha`,
    `inv_beta` [C] f32 from `constants`. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which reads and writes x's samples as [B, C, T] (the
    layout `layers.conv1d` returns): x lying otherwise is first copied so."""
    if not x.is_cuda:
        return snake_aa_plain(x, alpha, inv_beta)
    return _launch(x, alpha, inv_beta)


def _launch(x, alpha, inv_beta):
    from . import _build

    b, t, c = x.shape
    problems = []
    if x.dtype not in _DTYPES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    if alpha.shape != (c,) or inv_beta.shape != (c,) or alpha.dtype != torch.float32 or inv_beta.dtype != torch.float32:
        problems.append(f"alpha and inv_beta must be float32 [{c}]")
    if any(v.device != x.device for v in (alpha, inv_beta)):
        problems.append("all inputs must be on the same CUDA device")
    if t == 0:
        problems.append("T = 0")
    if problems:
        raise ValueError("snake_aa kernel: " + "; ".join(problems))
    rows = x.transpose(1, 2)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    out = torch.empty_like(rows)
    lib = _build.load("snake_aa", {"snake_aa_forward": _SIGNATURE})
    p = _build.ptr
    with _build.launch_on(x.device) as stream:
        rc = lib.snake_aa_forward(_DTYPES[x.dtype], b, c, t, p(rows), p(out), p(alpha.contiguous()),
                                  p(inv_beta.contiguous()), ctypes.cast(_taps_host()[1], ctypes.c_void_p), stream)
    _build.check(lib, rc, "snake_aa kernel")
    _COUNT.count += 1
    return out.transpose(1, 2)
