"""The bf16 tensor-core GEMM both layer stacks share: planner, plain version, wrapper.

`csrc/gemm_tc.cuh` is the kernel (wgmma from a TMA-filled shared-memory ring; its
source note says what bounds it on the H100 and what the design does about it).
`csrc/transformer_stack.cu` and `csrc/vocos_stack.cu` call it for every product when
the compute dtype is bf16; `csrc/gemm_tc.cu` exposes it alone as `gemm_tc_forward`,
which `gemm_tc` below wraps so that the product can be tested and timed apart from
the stacks. It is a part of those two kernels, not a kernel of its own path.

    C[M, N] = epilogue(A'[M, K] @ W[K, N])

`taps == 1`: A' = A, the rows of `[B, T, Cin]`. `taps == 3`: the k=3 SAME conv as one
product over K = 3 * Cin, row (b, t) of A' being [A[b, t-1], A[b, t], A[b, t+1]] with
zero rows past each sequence's ends. Epilogues, v = acc + bias in f32, `cd` the
output dtype (A's, bf16, unless `out_dtype` is float32; resid is in it too):

    EPI_BIAS         cd(v)
    EPI_BIAS_RELU    cd(max(v, 0))
    EPI_RESID_MASK   cd(cd(resid + cd(v)) * mask[m])
    EPI_GELU         cd(gelu_tanh(cd(v)))
    EPI_GAMMA_RESID  cd(resid + cd(v * gamma[n]))
    EPI_GELU_F32     cd(gelu_tanh(v))            (the single ConvNeXt block's w1)

The tile and the K split are chosen here, in `plan`, and handed to the C entry
points as ints. The split is a function of (N, K) alone: an output row is summed in
the same order whatever B and T are, which is what keeps two dispatch shapes of the
same rows bit-equal.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import counter

EPI_BIAS, EPI_BIAS_RELU, EPI_RESID_MASK, EPI_GELU, EPI_GAMMA_RESID, EPI_GELU_F32 = range(6)

BK = 64  # K elements per pipeline stage; a K tile never spans two conv taps
TILES = ((2, 128), (1, 128), (1, 64))  # (64-row consumer warpgroups, tile columns), largest first
SMS = 132
# The constants below come from `gemm_tc_sweep` on an H100 (every tile and split at the
# six serving products, M = 256 .. 8192). 64 x 128 is the best tile or within 5% of
# it nearly everywhere; 128 x 128 pays only where it still leaves two blocks an SM.
# A split adds a pass over an f32 workspace whose cost grows with M, and the split
# may not depend on M: three parts of K = 3072 (conv-FFN2) win up to M = 2048 (17.9
# -> 12.5 us there) and lose at M = 8192; K = 1536 (Vocos w2) only wins below
# M = 1280, so it is not split.
MAX_SPLIT = 3
MIN_TILES_PER_SPLIT = 16  # K tiles each part of a split still walks
SPLIT_MAX_N = 512  # wider products fill the card through their N tiles

_COUNT = counter("gemm_tc")
# gemm_tc_forward(B, T, Cin, taps, N, epi, out_f32, wgs, bn, split, A, Wt, C, bias, resid, mask, gamma,
#                 ws, stream)
_SIGNATURE = [ctypes.c_int] * 10 + [ctypes.c_void_p] * 9


def split_k(n: int, k: int) -> int:
    """Parts the K loop is cut into; a function of (N, K) only, dividing K / BK."""
    k_tiles = k // BK
    if n > SPLIT_MAX_N:
        return 1
    for s in range(min(MAX_SPLIT, k_tiles // MIN_TILES_PER_SPLIT), 1, -1):
        if k_tiles % s == 0:
            return s
    return 1


def k_ranges(n: int, k: int):
    """The [start, stop) K range of each part of the split, in split order."""
    s = split_k(n, k)
    step = k // BK // s * BK
    return [(i * step, (i + 1) * step) for i in range(s)]


def plan(batch: int, t_len: int, n: int, k: int) -> Tuple[int, int, int]:
    """(warpgroups, tile columns, split) for a product over `batch` sequences of
    `t_len` rows: 128 x 128 where that still gives two blocks an SM, else 64 x 128;
    64 x 64 for outputs no wider than 64 columns."""
    split = split_k(n, k)
    if n <= 64:
        return 1, 64, split
    if batch * -(-t_len // 128) * -(-n // 128) * split >= 2 * SMS:
        return 2, 128, split
    return 1, 128, split


def plan_args(plans, rows: int, widths, device):
    """What a stack's C entry point takes for its bf16 products: their plans as one
    flat int array, and the f32 workspace the split ones share ([split, rows, N] of the
    largest; one element when nothing is split)."""
    flat = (ctypes.c_int * (3 * len(plans)))(*(v for pl in plans for v in pl))
    size = max([pl[2] * rows * n for pl, n in zip(plans, widths) if pl[2] > 1], default=1)
    return flat, torch.empty((size,), dtype=torch.float32, device=device)


def problems(cin: int, n: int, taps: int = 1) -> list:
    """What the kernel does not take, as text; empty when it takes the product."""
    out = []
    if cin % BK:
        out.append(f"K per tap {cin} must be a multiple of {BK}")
    if n % 8:
        out.append(f"N={n} must be a multiple of 8")
    if taps not in (1, 3):
        out.append(f"taps={taps} (1 or 3)")
    return out


def im2col3(a: torch.Tensor) -> torch.Tensor:
    """[B, T, C] → [B, T, 3C]: rows [a[t-1], a[t], a[t+1]], zero past the ends."""
    zero = torch.zeros_like(a[:, :1])
    return torch.cat([torch.cat([zero, a[:, :-1]], 1), a, torch.cat([a[:, 1:], zero], 1)], dim=-1)


def gemm_tc_plain(
    a: torch.Tensor,  # [B, T, Cin]
    w: torch.Tensor,  # [taps * Cin, N]
    epi: int,
    bias: torch.Tensor,  # [N] f32
    resid: Optional[torch.Tensor] = None,  # [B, T, N]
    mask: Optional[torch.Tensor] = None,  # [B, T]
    gamma: Optional[torch.Tensor] = None,  # [N] f32
    taps: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The same function with torch ops: f32 product and epilogue, rounded to the
    output dtype (a's unless given) where the kernel rounds."""
    cd = out_dtype or a.dtype
    rows = im2col3(a) if taps == 3 else a
    v = rows.float() @ w.float() + bias
    if epi == EPI_BIAS:
        return v.to(cd)
    if epi == EPI_BIAS_RELU:
        return torch.relu(v).to(cd)
    if epi == EPI_RESID_MASK:
        return (resid + v.to(cd)) * mask.float()[..., None].to(cd)
    if epi == EPI_GELU:
        return F.gelu(v.to(cd).float(), approximate="tanh").to(cd)
    if epi == EPI_GAMMA_RESID:
        return resid + (v * gamma).to(cd)
    if epi == EPI_GELU_F32:
        return F.gelu(v, approximate="tanh").to(cd)
    raise ValueError(f"unknown epilogue {epi}")


def gemm_tc(a, w, epi, bias, resid=None, mask=None, gamma=None, taps: int = 1, wt=None, force_plan=None,
            out_dtype=None):
    """`gemm_tc_plain` for CPU tensors; on a CUDA tensor the kernel (bf16 operands,
    bf16 or float32 output) or a ValueError listing what it does not take. `wt` is
    `w.t().contiguous()` where the caller keeps it (the kernel reads W as [N, K]);
    else it is made here.
    `force_plan` = (warpgroups, tile columns, split) replaces `plan`'s choice: for
    `gemm_tc_sweep`, which is how the planner's constants were chosen."""
    if not a.is_cuda:
        return gemm_tc_plain(a, w, epi, bias, resid, mask, gamma, taps, out_dtype)
    from . import _build

    od = out_dtype or a.dtype
    b, t, cin = a.shape
    n = w.shape[-1]
    bad = problems(cin, n, taps)
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        bad.append(f"A {a.dtype} and W {w.dtype} must be bfloat16")
    if w.shape[0] != taps * cin:
        bad.append(f"W has {w.shape[0]} rows, A' has {taps * cin} columns")
    if wt is not None and (wt.shape != (n, taps * cin) or wt.dtype != w.dtype or not wt.is_contiguous()):
        bad.append("wt must be w.t().contiguous()")
    if od not in (torch.bfloat16, torch.float32):
        bad.append(f"output dtype {od} must be bfloat16 or float32")
    if epi not in range(6):
        bad.append(f"unknown epilogue {epi}")
    if epi in (EPI_RESID_MASK, EPI_GAMMA_RESID) and resid is None:
        bad.append("this epilogue needs resid")
    if (epi == EPI_RESID_MASK and mask is None) or (epi == EPI_GAMMA_RESID and gamma is None):
        bad.append("this epilogue needs its mask or gamma")
    if resid is not None and (resid.shape != (b, t, n) or resid.dtype != od):
        bad.append(f"resid {tuple(resid.shape)} {resid.dtype} must be {(b, t, n)} {od}")
    if mask is not None and mask.shape != (b, t):
        bad.append(f"mask shape {tuple(mask.shape)} != {(b, t)}")
    if bias.numel() != n or (gamma is not None and gamma.numel() != n):
        bad.append(f"bias and gamma must have N={n} elements")
    if any(x is not None and x.device != a.device for x in (w, wt, bias, resid, mask, gamma)):
        bad.append("all inputs must be on the same CUDA device")
    if bad:
        raise ValueError("gemm_tc kernel: " + "; ".join(bad))

    lib = _build.load("gemm_tc", {"gemm_tc_forward": _SIGNATURE})
    seqs, rows = (b, t) if taps == 3 else (1, b * t)
    wgs, bn, split = force_plan or plan(seqs, rows, n, taps * cin)
    if (wgs, bn) not in TILES or split < 1 or (taps * cin // BK) % split:
        raise ValueError(f"gemm_tc kernel: no tile {(wgs, bn)} or K tiles not divisible by split {split}")
    wt = w.t().contiguous() if wt is None else wt
    out = torch.empty((b, t, n), dtype=od, device=a.device)
    ws = torch.empty((split * b * t * n if split > 1 else 1,), dtype=torch.float32, device=a.device)
    # Kept in names until the launch has been queued: a temporary's memory could be reused.
    a_c, bias_c = a.contiguous(), bias.float().contiguous()
    resid_c = None if resid is None else resid.contiguous()
    mask_c = None if mask is None else mask.float().contiguous()
    gamma_c = None if gamma is None else gamma.float().contiguous()
    p = lambda x: None if x is None else _build.ptr(x)  # noqa: E731
    with _build.launch_on(a.device) as stream:
        rc = lib.gemm_tc_forward(
            seqs, rows, cin, taps, n, epi, int(od == torch.float32), wgs, bn, split, p(a_c), p(wt), p(out), p(bias_c),
            p(resid_c), p(mask_c), p(gamma_c), p(ws), stream,
        )
    _build.check(lib, rc, "gemm_tc kernel")
    _COUNT.count += 1
    return out
