"""Vocos ConvNeXt stack: hand-written CUDA kernel and its plain PyTorch version.

Replaces `gonova_tts_tpu/ops/vocos_stack_kernel.py` `vocos_stack_pallas` (the JAX
vocoder's block stack under `ModelConfig.vocos_pallas`). The kernel is
`csrc/vocos_stack.cu`; its source note says what bounds it on the H100 (the two
MLP GEMMs: operations) and what the design does about it: in bf16 both run on the
tensor cores through `csrc/gemm_tc.cuh` (planned by `gemm_tc.plan`); float32 stays
on the CUDA cores.

`vocos_stack_plain` computes the same function in PyTorch, staged as the Pallas
kernel stages it (f32 depthwise taps and LN, MLP products accumulated in f32,
bf16 rounding at the same places). In f32 it equals the `vocos._block_apply` loop.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from . import counter, gemm_tc

MAX_T = 768  # the JAX dispatch's kernel budget (vocos.forward); longer mels stay plain
_COUNT = counter("vocos_stack")
# vocos_stack_forward(dtype, B, T, C, F, L, act, 9 weights, 2 scratch buffers, plans,
# workspace, stream)
_SIGNATURE = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 15


def pack_params(blocks, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A list of vocos block trees → per-block arrays: dw [L, 7, C] and the other
    vectors f32, w1 [L, C, F] and w2 [L, F, C] in `dtype`. For bfloat16 also the
    [N, K] copies the tensor-core GEMM reads, w1_t [L, F, C] and w2_t [L, C, F]; the
    plain version reads the [K, N] ones."""
    blocks = list(blocks)

    def st(fn, dt=torch.float32):
        return torch.stack([fn(b).detach() for b in blocks]).to(dt).contiguous()

    packed = {
        "dw": st(lambda b: b["dw"]), "dw_b": st(lambda b: b["dw_b"]),
        "ln_g": st(lambda b: b["ln"]["g"]), "ln_b": st(lambda b: b["ln"]["b"]),
        "w1": st(lambda b: b["pw1"]["w"], dtype), "b1": st(lambda b: b["pw1"]["b"]),
        "w2": st(lambda b: b["pw2"]["w"], dtype), "b2": st(lambda b: b["pw2"]["b"]),
        "gamma": st(lambda b: b["gamma"]),
    }
    if dtype == torch.bfloat16:
        for k in ("w1", "w2"):
            packed[k + "_t"] = packed[k].transpose(1, 2).contiguous()
    return packed


def tc_plans(b: int, t: int, c: int, f: int) -> list:
    """(warpgroups, tile columns, split) of w1 and of w2 in bf16: rows as one
    sequence of B*T."""
    return [gemm_tc.plan(1, b * t, f, c), gemm_tc.plan(1, b * t, c, f)]


def vocos_stack_plain(x: torch.Tensor, packed: Mapping[str, torch.Tensor], bf16: bool = False) -> torch.Tensor:
    cd = torch.bfloat16 if bf16 else torch.float32
    c = x.shape[-1]
    act = x.to(cd)
    for l in range(packed["dw"].shape[0]):
        k = packed["dw"].shape[1]
        w = packed["dw"][l].t()[:, None, :]  # [C, 1, k]
        # Contiguous rows: the CPU reductions over a strided last dim would sum a row
        # in an order set by its position, and the kernel's rows do not depend on T.
        acc = F.conv1d(act.float().transpose(1, 2), w, padding=k // 2, groups=c).transpose(1, 2).contiguous()
        acc = acc + packed["dw_b"][l]
        mean = acc.mean(-1, keepdim=True)
        var = ((acc - mean) ** 2).mean(-1, keepdim=True)
        normed = ((acc - mean) * torch.rsqrt(var + 1e-5) * packed["ln_g"][l] + packed["ln_b"][l]).to(cd)
        h = (normed.float() @ packed["w1"][l].float() + packed["b1"][l]).to(cd)
        h = F.gelu(h.float(), approximate="tanh").to(cd)
        h = h.float() @ packed["w2"][l].float() + packed["b2"][l]
        act = act + (h * packed["gamma"][l]).to(cd)
    return act


def vocos_stack(x: torch.Tensor, packed: Mapping[str, torch.Tensor], bf16: bool = False) -> torch.Tensor:
    """Fused equivalent of the `vocos._block_apply` loop over [B, T, C]; returns the
    compute dtype. CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not x.is_cuda:
        return vocos_stack_plain(x, packed, bf16)
    return _launch(x, packed, bf16)


def _launch(x, packed, bf16):
    from . import _build

    cd = torch.bfloat16 if bf16 else torch.float32
    b, t, c = x.shape
    n_layers, f = packed["w1"].shape[0], packed["w1"].shape[-1]
    problems = []
    if t > MAX_T:
        problems.append(f"T={t} > MAX_T={MAX_T}")
    if c % 16 or f % 16 or c > 1024:
        problems.append(f"C={c} and F={f} must be multiples of 16, C <= 1024")
    if packed["dw"].shape[1] != 7:
        problems.append(f"depthwise kernel {packed['dw'].shape[1]} != 7")
    if any(v.device != x.device for v in packed.values()):
        problems.append("all inputs must be on the same CUDA device")
    if packed["w1"].dtype != cd:
        problems.append(f"weights packed as {packed['w1'].dtype}, compute dtype {cd}")
    if bf16:
        problems += gemm_tc.problems(c, f) + gemm_tc.problems(f, c)
        if "w2_t" not in packed:
            problems.append("bf16 needs the transposed weights of pack_params(blocks, torch.bfloat16)")
    if problems:
        raise ValueError("vocos_stack kernel: " + "; ".join(problems))

    lib = _build.load("vocos_stack", {"vocos_stack_forward": _SIGNATURE})
    act = x.to(cd, copy=True).contiguous()
    normed = torch.empty((b * t, c), dtype=cd, device=x.device)
    h = torch.empty((b * t, f), dtype=cd, device=x.device)
    p = _build.ptr
    weights, plans, ws = packed, None, None
    if bf16:  # the [N, K] weights, both products' tile and split, the split's workspace
        weights = {**packed, "w1": packed["w1_t"], "w2": packed["w2_t"]}
        plans, ws = gemm_tc.plan_args(tc_plans(b, t, c, f), b * t, (f, c), x.device)
    with _build.launch_on(x.device) as stream:
        rc = lib.vocos_stack_forward(
            int(bf16), b, t, c, f, n_layers, p(act),
            *(p(weights[k]) for k in ("dw", "dw_b", "ln_g", "ln_b", "w1", "b1", "w2", "b2", "gamma")),
            p(normed), p(h), plans, None if ws is None else p(ws), stream,
        )
    _build.check(lib, rc, "vocos_stack kernel")
    _COUNT.count += 1
    return act
