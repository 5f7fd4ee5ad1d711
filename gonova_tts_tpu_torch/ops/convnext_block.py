"""One ConvNeXt block: hand-written CUDA kernel and its plain PyTorch version.

Replaces `gonova_tts_tpu/ops/convnext_kernel.py` `convnext_block_pallas`, with its
signature. No model path calls the single-block kernel (the vocoder runs the whole
stack through `vocos_stack`); it is kept as the JAX package keeps it, as the
one-block form of the vocoder's hot loop. The kernel is `csrc/convnext_block.cu`;
its source note says what bounds it on the H100 (the two MLP GEMMs: operations)
and where it differs from one iteration of the stack kernel.

`convnext_block_plain` computes the same function in PyTorch, staged as the Pallas
kernel stages it: f32 depthwise taps and LN; the LN output cast to the MLP dtype
(bf16 when `bf16`, else f32); products accumulated in f32; the GELU applied to the
f32 sum and only its result cast to the MLP dtype; `h * gamma` rounded to x's
dtype before the residual add. The activation dtype is x's own, whatever `bf16`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import counter

_COUNT = counter("convnext_block")
# convnext_block_forward(x_dtype, mlp_dtype, B, T, C, F, eps, x, out, 9 weights,
#                        2 scratch buffers, stream)
_SIGNATURE = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_void_p] * 14
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def convnext_block_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-5, bf16: bool = True):
    md = torch.bfloat16 if bf16 else torch.float32
    c = x.shape[-1]
    k = dw.shape[0]
    w = dw.float().t()[:, None, :]  # [C, 1, k]
    acc = F.conv1d(x.float().transpose(1, 2), w, padding=k // 2, groups=c).transpose(1, 2) + dw_b.float()
    mean = acc.mean(-1, keepdim=True)
    var = ((acc - mean) ** 2).mean(-1, keepdim=True)
    normed = ((acc - mean) * torch.rsqrt(var + eps) * ln_g.float() + ln_b.float()).to(md)
    h = normed.float() @ w1.to(md).float() + b1.float()
    h = F.gelu(h, approximate="tanh").to(md)
    h = h.float() @ w2.to(md).float() + b2.float()
    return x + (h * gamma.float()).to(x.dtype)


def convnext_block(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-5, bf16: bool = True):
    """x [B, T, C] f32 or bf16, dw [7, C], vectors [C] / [F], w1 [C, F], w2 [F, C]
    → [B, T, C] in x's dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if not x.is_cuda:
        return convnext_block_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, eps, bf16)
    return _launch(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, eps, bf16)


def _launch(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, eps, bf16):
    from . import _build

    md = torch.bfloat16 if bf16 else torch.float32
    if x.ndim != 3 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"convnext_block kernel: x must be [B, T, C] f32 or bf16, got {tuple(x.shape)} {x.dtype}")
    b, t, c = x.shape
    f = w1.shape[-1]
    problems = []
    if c % 16 or f % 16 or c > 1024:
        problems.append(f"C={c} and F={f} must be multiples of 16, C <= 1024")
    if tuple(dw.shape) != (7, c):
        problems.append(f"dw {tuple(dw.shape)} != (7, {c})")
    if tuple(w1.shape) != (c, f) or tuple(w2.shape) != (f, c):
        problems.append(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} != ({c}, {f}) / ({f}, {c})")
    weights = (dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma)
    if any(v.device != x.device for v in weights):
        problems.append("all inputs must be on the same CUDA device")
    if problems:
        raise ValueError("convnext_block kernel: " + "; ".join(problems))

    lib = _build.load("convnext_block", {"convnext_block_forward": _SIGNATURE})
    x = x.contiguous()
    vec = lambda v: v.detach().float().contiguous()  # noqa: E731
    dw, dw_b, ln_g, ln_b, b1, b2, gamma = map(vec, (dw, dw_b, ln_g, ln_b, b1, b2, gamma))
    w1, w2 = w1.detach().to(md).contiguous(), w2.detach().to(md).contiguous()
    out = torch.empty_like(x)
    normed = torch.empty((b * t, c), dtype=md, device=x.device)
    h = torch.empty((b * t, f), dtype=md, device=x.device)
    p = _build.ptr
    rc = lib.convnext_block_forward(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[md], b, t, c, f, float(eps), p(x), p(out),
        *(p(v) for v in (dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma)),
        p(normed), p(h), _build.stream_ptr(x.device),
    )
    _build.check(lib, rc, "convnext_block kernel")
    _COUNT.count += 1
    return out
