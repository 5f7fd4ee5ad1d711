"""One ConvNeXt block: hand-written CUDA kernel and its plain PyTorch version.

Replaces `gonova_tts_tpu/ops/convnext_kernel.py` `convnext_block_pallas`, with its
signature. No model path calls the single-block kernel (the vocoder runs the whole
stack through `vocos_stack`); it is kept as the JAX package keeps it, as the
one-block form of the vocoder's hot loop. The kernel is `csrc/convnext_block.cu`;
its source note says what bounds it on the H100 (the two MLP products: operations)
and where it differs from one iteration of the stack kernel. With bf16 MLP operands
both products run on the tensor-core GEMM of `csrc/gemm_tc.cuh` (planned by
`gemm_tc.plan`; C and F multiples of 64), reading [N, K] bf16 copies of w1 and w2
that are made once per weight tensor and cached; with f32 MLP operands they stay on
the CUDA cores.

`convnext_block_plain` computes the same function in PyTorch, staged as the Pallas
kernel stages it: f32 depthwise taps and LN; the LN output cast to the MLP dtype
(bf16 when `bf16`, else f32); products accumulated in f32; the GELU applied to the
f32 sum and only its result cast to the MLP dtype; `h * gamma` rounded to x's
dtype before the residual add. The activation dtype is x's own, whatever `bf16`.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict

import torch
import torch.nn.functional as F

from . import counter, gemm_tc

_COUNT = counter("convnext_block")
# convnext_block_forward(x_dtype, mlp_dtype, B, T, C, F, eps, x, out, 9 weights,
#                        2 scratch buffers, plans, workspace, stream)
_SIGNATURE = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_void_p] * 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TC_WEIGHTS: Dict[int, tuple] = {}  # id(w) -> (weakref to w, w._version, bf16 [N, K] copy)


def dwconv_ln_plain(x, dw, dw_b, ln_g, ln_b, eps: float, md: torch.dtype) -> torch.Tensor:
    """The block's first half: f32 depthwise k=7 conv (zero edges) + bias, f32 LN,
    cast to the MLP dtype `md`."""
    c = x.shape[-1]
    k = dw.shape[0]
    w = dw.float().t()[:, None, :]  # [C, 1, k]
    acc = F.conv1d(x.float().transpose(1, 2), w, padding=k // 2, groups=c).transpose(1, 2) + dw_b.float()
    mean = acc.mean(-1, keepdim=True)
    var = ((acc - mean) ** 2).mean(-1, keepdim=True)
    return ((acc - mean) * torch.rsqrt(var + eps) * ln_g.float() + ln_b.float()).to(md)


def convnext_block_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-5, bf16: bool = True):
    md = torch.bfloat16 if bf16 else torch.float32
    normed = dwconv_ln_plain(x, dw, dw_b, ln_g, ln_b, eps, md)
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


def tc_weight(w: torch.Tensor) -> torch.Tensor:
    """The bf16 [N, K] copy of a [K, N] MLP weight that the tensor-core GEMM reads,
    made once per tensor object and kept until it is written to (its `_version`).
    Keyed on the object, not on its address: a freed weight's memory is soon another
    weight's, at version 0 and of the same shape. The copy goes when the tensor dies."""
    key = id(w)
    hit = _TC_WEIGHTS.get(key)
    if hit is None or hit[0]() is not w or hit[1] != w._version:
        copy = w.detach().to(torch.bfloat16).t().contiguous()
        hit = (weakref.ref(w, lambda ref: _evict(key, ref)), w._version, copy)
        _TC_WEIGHTS[key] = hit
    return hit[2]


def _evict(key: int, ref: weakref.ref) -> None:
    """A cached weight died: drop its copy, unless the key is already another's."""
    if _TC_WEIGHTS.get(key, (None,))[0] is ref:
        del _TC_WEIGHTS[key]


def _f32(v: torch.Tensor) -> torch.Tensor:
    """v as a contiguous float32 tensor, v itself when it is one already."""
    return v if v.dtype == torch.float32 and v.is_contiguous() else v.detach().float().contiguous()


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
    if bf16:  # the tensor-core GEMM: K of both products a multiple of 64
        problems += gemm_tc.problems(c, f) + gemm_tc.problems(f, c)
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
    dw, dw_b, ln_g, ln_b, b1, b2, gamma = map(_f32, (dw, dw_b, ln_g, ln_b, b1, b2, gamma))
    plans, ws = None, None
    if bf16:  # the [N, K] copies, both products' tile and split, a split's workspace
        w1, w2 = tc_weight(w1), tc_weight(w2)
        m = b * t
        plans, ws = gemm_tc.plan_args([gemm_tc.plan(1, m, f, c), gemm_tc.plan(1, m, c, f)], m, (f, c), x.device)
    else:
        w1, w2 = _f32(w1), _f32(w2)
    out = torch.empty_like(x)
    normed = torch.empty((b * t, c), dtype=md, device=x.device)
    h = torch.empty((b * t, f), dtype=md, device=x.device)
    p = _build.ptr
    with _build.launch_on(x.device) as stream:
        rc = lib.convnext_block_forward(
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[md], b, t, c, f, float(eps), p(x), p(out),
            *(p(v) for v in (dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma)),
            p(normed), p(h), plans, None if ws is None else p(ws), stream,
        )
    _build.check(lib, rc, "convnext_block kernel")
    _COUNT.count += 1
    return out
