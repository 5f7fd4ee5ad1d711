"""Anti-aliased Snake-beta: hand-written CUDA kernel and its plain PyTorch version.

BigVGAN-v2's activation (`Activation1d(SnakeBeta)` of NVIDIA's BigVGAN, arXiv:2206.04658),
109 times in each forward of `models/bigvgan.py`. No TPU kernel stands behind it:
the JAX package has no BigVGAN. The kernel is `csrc/snake_aa.cu`; its source note
says what bounds it on the H100 (bytes) and what the design does about it (one read
and one write of x, channels-last; each lane walks its channels along time with the
upsampled signal in registers).

Per channel c of x [B, T, C] (plus `bias[c]` where given: the bias of the conv before
it, which that conv leaves to its one reader), with the 12-tap low-pass
`kaiser_sinc_filter()` f:

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
from typing import Optional, Tuple

import torch

from . import counter

TAPS = 12
# Input samples each side that one output reads: the upsampler's phases read x[p-3 .. p+2]
# and x[p-2 .. p+3], the downsampler's output m the upsampled a[2m-5 .. 2m+6].
REACH = 5
_COUNT = counter("snake_aa")
# snake_aa_forward(dtype, B, C, T, vec, seg, x, y, alpha, inv_beta, bias, taps, stream)
_SIGNATURE = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 7
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (channels a lane, outputs a lane) that `csrc/snake_aa.cu` builds; PLAN is the one
# the wrapper launches (the fastest at the published stages, PERF.md §6), with fewer
# channels a lane where C or x's alignment does not take PLAN's.
PLANS = ((1, 16), (2, 16), (2, 32), (4, 16))
PLAN = (2, 16)


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


def snake_aa_plain(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    f = _taps_host()[0].to(x.device)
    t = x.shape[1]
    xf = x.float() if bias is None else x.float() + bias
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


def snake_aa(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, C] (f32 or bf16) → the activation of x + `bias`, [B, T, C] contiguous
    in x's dtype; `alpha`, `inv_beta` [C] f32 from `constants`, `bias` [C] f32 or
    None. CPU tensors take the plain version; CUDA tensors launch the kernel, which
    reads x channels-last: x lying otherwise is first copied so."""
    if not x.is_cuda:
        return snake_aa_plain(x, alpha, inv_beta, bias)
    return _launch(x, alpha, inv_beta, bias)


def _plan(c: int, x: torch.Tensor, plan: Tuple[int, int]) -> Tuple[int, int]:
    """`plan` with its channels a lane halved until they divide C and keep x's rows
    aligned for the vector load (one channel a lane takes anything)."""
    vec, seg = plan
    while vec > 1 and (c % vec or x.data_ptr() % (vec * x.element_size())):
        vec //= 2
    return (vec, seg) if (vec, seg) in PLANS else (1, 16)


def _launch(x, alpha, inv_beta, bias=None, plan=PLAN):
    from . import _build

    b, t, c = x.shape
    problems = []
    if x.dtype not in _DTYPES:
        problems.append(f"dtype {x.dtype} (float32 or bfloat16)")
    consts = (alpha, inv_beta) if bias is None else (alpha, inv_beta, bias)
    if any(v.shape != (c,) or v.dtype != torch.float32 for v in consts):
        problems.append(f"alpha, inv_beta and bias must be float32 [{c}]")
    if any(v.device != x.device for v in consts):
        problems.append("all inputs must be on the same CUDA device")
    if t == 0:
        problems.append("T = 0")
    if plan not in PLANS:
        problems.append(f"plan {plan} is not one of {PLANS}")
    if problems:
        raise ValueError("snake_aa kernel: " + "; ".join(problems))
    x = x.contiguous()
    out = torch.empty_like(x)
    vec, seg = _plan(c, x, plan)
    lib = _build.load("snake_aa", {"snake_aa_forward": _SIGNATURE})
    p = _build.ptr
    with _build.launch_on(x.device) as stream:
        rc = lib.snake_aa_forward(_DTYPES[x.dtype], b, c, t, vec, seg, p(x), p(out), p(alpha.contiguous()),
                                  p(inv_beta.contiguous()), None if bias is None else p(bias.contiguous()),
                                  ctypes.cast(_taps_host()[1], ctypes.c_void_p), stream)
    _build.check(lib, rc, "snake_aa kernel")
    _COUNT.count += 1
    return out
