"""Acoustic transformer stack: hand-written CUDA kernel and its plain PyTorch version.

Replaces `gonova_tts_tpu/ops/transformer_stack_kernel.py` `transformer_stack_pallas`
(the JAX encoder/decoder stacks under `ModelConfig.acoustic_pallas`). The kernel is
`csrc/transformer_stack.cu`; its source note says what bounds it on the H100
(operations) and what the design does about it: in bf16 every product runs on the
tensor cores through `csrc/gemm_tc.cuh` (planned by `gemm_tc.plan`) and attention
through `attention_tc_kernel`; float32 stays on the CUDA cores.

`transformer_stack_plain` computes the same function in PyTorch, staged as the
Pallas kernel stages it (fused QKV, f32 logits and softmax, conv FFN as three taps,
bf16 rounding at the same places). In f32 it equals `layers.transformer_stack`.

Masks: both paths read each key's mask value, so unlike the Pallas kernel (whose
local path assumed prefix masks) any [B, T] 0/1 mask is taken on the local path too.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Mapping, Optional

import torch

from ..models.layers import NEG, with_neighbors, uses_local_attention
from . import counter, gemm_tc

MAX_T = 768  # the JAX dispatch's kernel budget (acoustic._stack); longer stacks stay plain
_COUNT = counter("transformer_stack")
# transformer_stack_forward(dtype, B, T, D, H, F, L, window, 16 inputs, 6 outputs
# and scratch buffers, plans, workspace, stream)
_SIGNATURE = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 25
_TC_HEAD_WIDTHS = (16, 32, 64)  # attention_tc_kernel's instantiations


def pack_params(stack: Mapping, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A `layers.transformer_stack` tree → per-layer arrays in the kernel layout.

    wqkv [L, D, 3D] (q | k | v columns), wo [L, D, D], w1 [L, 3, D, F] and
    w2 [L, 3, F, D] (conv taps, WIO) in `dtype`; biases and LN parameters f32.
    For bfloat16 also the [N, K] copies the tensor-core GEMM reads: wqkv_t
    [L, 3D, D], wo_t [L, D, D], w1_t [L, F, 3D], w2_t [L, D, 3F]. The plain version
    reads the [K, N] ones."""
    blocks = list(stack["blocks"])

    def st(fn, dt=torch.float32):
        return torch.stack([fn(b).detach() for b in blocks]).to(dt).contiguous()

    attn = lambda b, k, part: b["attn"][k][part]  # noqa: E731
    packed = {
        "ln1_g": st(lambda b: b["ln1"]["g"]), "ln1_b": st(lambda b: b["ln1"]["b"]),
        "ln2_g": st(lambda b: b["ln2"]["g"]), "ln2_b": st(lambda b: b["ln2"]["b"]),
        "wqkv": st(lambda b: torch.cat([attn(b, k, "w") for k in "qkv"], dim=1), dtype),
        "bqkv": st(lambda b: torch.cat([attn(b, k, "b") for k in "qkv"])),
        "wo": st(lambda b: attn(b, "o", "w"), dtype), "bo": st(lambda b: attn(b, "o", "b")),
        "w1": st(lambda b: b["ff1"]["w"], dtype), "b1": st(lambda b: b["ff1"]["b"]),
        "w2": st(lambda b: b["ff2"]["w"], dtype), "b2": st(lambda b: b["ff2"]["b"]),
        "lno_g": stack["ln_out"]["g"].detach().float().contiguous(),
        "lno_b": stack["ln_out"]["b"].detach().float().contiguous(),
    }
    if dtype == torch.bfloat16:
        for k in ("wqkv", "wo", "w1", "w2"):
            w = packed[k]
            packed[k + "_t"] = w.reshape(w.shape[0], -1, w.shape[-1]).transpose(1, 2).contiguous()
    return packed


def tc_plans(b: int, t: int, d: int, f: int) -> list:
    """(warpgroups, tile columns, split) of the four products of a bf16 layer, in the
    order the kernel reads them: QKV, out-projection (rows as one sequence of B*T),
    conv-FFN1, conv-FFN2 (B sequences of T rows)."""
    return [
        gemm_tc.plan(1, b * t, 3 * d, d), gemm_tc.plan(1, b * t, d, d),
        gemm_tc.plan(b, t, f, 3 * d), gemm_tc.plan(b, t, d, 3 * f),
    ]


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * g + b


def _conv3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k=3 SAME conv per sequence as one product over K = 3*C: [x[t-1], x[t], x[t+1]]."""
    zero = torch.zeros_like(x[:, :1])
    taps = torch.cat(
        [torch.cat([zero, x[:, :-1]], 1), x, torch.cat([x[:, 1:], zero], 1)], dim=-1
    )
    return taps.float() @ w.float().reshape(-1, w.shape[-1])


def transformer_stack_plain(
    x: torch.Tensor,  # [B, T, D]
    mask: torch.Tensor,  # [B, T], 1 = valid
    packed: Mapping[str, torch.Tensor],
    n_heads: int,
    window: Optional[int] = None,
    bf16: bool = False,
) -> torch.Tensor:
    cd = torch.bfloat16 if bf16 else torch.float32
    b, t, d = x.shape
    dh = d // n_heads
    local = uses_local_attention(window, t)
    if local and t % window != 0:
        raise ValueError(f"T={t} must be a multiple of window={window}")
    mask_c = mask.float()[..., None].to(cd)
    key_bias = torch.where(mask != 0, 0.0, NEG)  # [B, T] f32
    act = x.to(cd)
    for l in range(packed["wqkv"].shape[0]):
        normed = _ln(act, packed["ln1_g"][l], packed["ln1_b"][l]).to(cd)
        qkv = (normed.float() @ packed["wqkv"][l].float() + packed["bqkv"][l]).to(cd)
        q, k, v = (u.reshape(b, t, n_heads, dh).float() for u in qkv.split(d, dim=-1))
        if local:
            nb = t // window
            q = q.reshape(b, nb, window, n_heads, dh)
            kn = with_neighbors(k.reshape(b, nb, window, n_heads, dh))
            vn = with_neighbors(v.reshape(b, nb, window, n_heads, dh))
            # Zero-edged neighbour mask: keys past either end get the NEG bias.
            km = with_neighbors(mask.float().reshape(b, nb, window))
            bias = torch.where(km != 0, 0.0, NEG)
            logits = torch.einsum("bnqhd,bnkhd->bnhqk", q, kn) / math.sqrt(dh)
            p = torch.softmax(logits + bias[:, :, None, None, :], dim=-1).to(cd)
            att = torch.einsum("bnhqk,bnkhd->bnqhd", p.float(), vn).to(cd)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
            p = torch.softmax(logits + key_bias[:, None, None, :], dim=-1).to(cd)
            att = torch.einsum("bhqk,bkhd->bqhd", p.float(), v).to(cd)
        acc = att.reshape(b, t, d).float() @ packed["wo"][l].float() + packed["bo"][l]
        h_res = (act + acc.to(cd)) * mask_c
        n2 = _ln(h_res, packed["ln2_g"][l], packed["ln2_b"][l]).to(cd)
        h1 = torch.relu(_conv3(n2, packed["w1"][l]) + packed["b1"][l]).to(cd)
        y = _conv3(h1, packed["w2"][l]) + packed["b2"][l]
        act = (h_res + y.to(cd)) * mask_c
    return _ln(act, packed["lno_g"], packed["lno_b"]).to(cd)


def transformer_stack(
    x: torch.Tensor,
    mask: torch.Tensor,
    packed: Mapping[str, torch.Tensor],
    n_heads: int,
    window: Optional[int] = None,
    bf16: bool = False,
) -> torch.Tensor:
    """Fused equivalent of `layers.transformer_stack(p, x, n_heads, mask, dtype,
    attention_window=window)`; returns the compute dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if not x.is_cuda:
        return transformer_stack_plain(x, mask, packed, n_heads, window, bf16)
    return _launch(x, mask, packed, n_heads, window, bf16)


def _launch(x, mask, packed, n_heads, window, bf16):
    from . import _build

    cd = torch.bfloat16 if bf16 else torch.float32
    b, t, d = x.shape
    n_layers, f = packed["w1"].shape[0], packed["w1"].shape[-1]
    dh = d // n_heads
    local = uses_local_attention(window, t)
    problems = []
    if d % n_heads or dh > 128:
        problems.append(f"head width {d}/{n_heads} (must divide, <= 128)")
    if d % 16 or f % 16:
        problems.append(f"D={d} and F={f} must be multiples of 16")
    if bf16:
        problems += gemm_tc.problems(d, 3 * d) + gemm_tc.problems(f, d, taps=3)
        if dh not in _TC_HEAD_WIDTHS:
            problems.append(f"bf16 attention takes head widths {_TC_HEAD_WIDTHS}, not {dh}")
        if "w2_t" not in packed:
            problems.append("bf16 needs the transposed weights of pack_params(stack, torch.bfloat16)")
    if local and (t % window or window % 8):
        problems.append(f"local attention needs T % window == 0 and window % 8 == 0 (T={t}, w={window})")
    if mask.shape != (b, t):
        problems.append(f"mask shape {tuple(mask.shape)} != {(b, t)}")
    if any(v.device != x.device for v in (mask, *packed.values())):
        problems.append("all inputs must be on the same CUDA device")
    if packed["wqkv"].dtype != cd:
        problems.append(f"weights packed as {packed['wqkv'].dtype}, compute dtype {cd}")
    if problems:
        raise ValueError("transformer_stack kernel: " + "; ".join(problems))

    lib = _build.load("transformer_stack", {"transformer_stack_forward": _SIGNATURE})
    act = x.to(cd, copy=True).contiguous()
    maskf = mask.float().contiguous()
    m = b * t
    new = lambda *shape: torch.empty(shape, dtype=cd, device=x.device)  # noqa: E731
    normed, qkv, att, hres, h1, out = (
        new(m, d), new(m, 3 * d), new(m, d), new(m, d), new(m, f), new(b, t, d)
    )
    p = _build.ptr
    weights, plans, ws = packed, None, None
    if bf16:  # the [N, K] weights, each product's tile and split, the split's workspace
        weights = {**packed, **{k: packed[k + "_t"] for k in ("wqkv", "wo", "w1", "w2")}}
        plans, ws = gemm_tc.plan_args(tc_plans(b, t, d, f), m, (3 * d, d, f, d), x.device)
    with _build.launch_on(x.device) as stream:
        rc = lib.transformer_stack_forward(
            int(bf16), b, t, d, n_heads, f, n_layers, window if local else 0, p(maskf), p(act),
            *(p(weights[k]) for k in (
                "ln1_g", "ln1_b", "ln2_g", "ln2_b", "wqkv", "bqkv", "wo", "bo",
                "w1", "b1", "w2", "b2", "lno_g", "lno_b",
            )),
            p(normed), p(qkv), p(att), p(hres), p(h1), p(out), plans, None if ws is None else p(ws), stream,
        )
    _build.check(lib, rc, "transformer_stack kernel")
    _COUNT.count += 1
    return out

