"""Shared neural layers: plain PyTorch functions over parameter trees.

Counterpart of `gonova_tts_tpu/models/layers.py`. Parameters live in `Tree`
modules whose children are addressed like the JAX parameter dicts
(`p["attn"]["q"]["w"]`), so every function here reads like its JAX twin and
also takes a plain nested dict of tensors. Layouts are the JAX ones: activations
`[B, T, C]`, dense `[in, out]`, conv `[k, C_in, C_out]`, depthwise `[k, C]`.

Initializers take an explicit `torch.Generator`; their distributions mirror the
JAX initializers (the numbers differ: parity tests load one JAX tree into both).

Tensor parallelism: a parameter sharded over the mesh's 'model' axis
(`parallel/mesh.py::shard_params`) holds its rank's block and its split dimension
(`tp.split_dim`). `dense` and `conv1d` then run column-parallel (output columns
split: this rank's block of the output) or row-parallel (input split: partial
products all-reduced, the replicated bias added after), `embedding` gathers the
model dimension after the lookup, and attention runs this rank's whole heads. With
no sharded parameter every function is the plain one.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..parallel import tp

NEG = -1e9
_PHASED = ops.counter("conv_phased")
_NWC = ops.counter("conv_nwc")


class Tree(nn.Module):
    """An `nn.Module` addressed like a JAX parameter dict: `tree["key"]` is the
    child module or parameter registered under that name."""

    def __getitem__(self, key: str):
        return getattr(self, key)


def leaf(**tensors: torch.Tensor) -> Tree:
    """A tree node holding parameters only (a dense, conv or LayerNorm)."""
    node = Tree()
    for name, value in tensors.items():
        node.register_parameter(name, nn.Parameter(value, requires_grad=False))
    return node


def group(**children) -> Tree:
    node = Tree()
    for name, child in children.items():
        node.add_module(name, child)
    return node


# ---------------------------------------------------------------- init helpers


def _normal(g: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32) * scale


def dense_init(g: torch.Generator, in_dim: int, out_dim: int, scale: Optional[float] = None) -> Tree:
    if scale is None:
        scale = math.sqrt(2.0 / (in_dim + out_dim))  # xavier
    return leaf(w=_normal(g, (in_dim, out_dim), scale), b=torch.zeros(out_dim))


def conv1d_init(
    g: torch.Generator, in_ch: int, out_ch: int, kernel: int, scale: Optional[float] = None,
    groups: int = 1,
) -> Tree:
    """Weight [kernel, in_ch // groups, out_ch] and bias [out_ch]."""
    if in_ch % groups or out_ch % groups:
        raise ValueError(f"groups={groups} must divide in_ch={in_ch} and out_ch={out_ch}")
    if scale is None:
        scale = math.sqrt(2.0 / (kernel * in_ch // groups + out_ch))
    return leaf(w=_normal(g, (kernel, in_ch // groups, out_ch), scale), b=torch.zeros(out_ch))


def layernorm_init(dim: int) -> Tree:
    return leaf(g=torch.ones(dim), b=torch.zeros(dim))


def embedding_init(g: torch.Generator, vocab: int, dim: int) -> Tree:
    return leaf(table=_normal(g, (vocab, dim), 0.02))


# ---------------------------------------------------------------- apply fns


ROW_TILE = 128  # rows of each product `tiled_matmul` issues


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, tile: int = ROW_TILE) -> torch.Tensor:
    """x [..., K] @ w [K, N] as products of exactly `tile` rows (the last one
    zero-padded), so that a row's result does not depend on how many rows share the
    call. BLAS libraries choose the blocking and the K split of a product by its
    shape: without the tiles a row of a short streamed window rounds otherwise than
    the same row of a longer pass."""
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    m = rows.shape[0]
    rows = F.pad(rows, (0, 0, 0, -m % tile))
    y = torch.cat([rows[i : i + tile] @ w for i in range(0, rows.shape[0], tile)])
    return y[:m].reshape(*lead, w.shape[-1])


def dense(p: Mapping, x: torch.Tensor, dtype=torch.float32, tiled: bool = False) -> torch.Tensor:
    """x @ w + b. Column-parallel w (split on out): this rank's output columns;
    row-parallel w (split on in): x holds this rank's input columns. `tiled` takes
    the product through `tiled_matmul` (a replicated w only)."""
    w = p["w"]
    split = tp.split_dim(w)
    if split == 1:
        x = tp.copy(x)
    if tiled and split is None:
        y = tiled_matmul(x.to(dtype), w.to(dtype))
    else:
        y = x.to(dtype) @ w.to(dtype)
    if split == 0:
        y = tp.reduce(y)
    return y + p["b"].to(dtype)


def embedding(p: Mapping, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    table = p["table"]
    y = table.to(dtype)[ids]
    return tp.gather(y) if tp.split_dim(table) is not None else y


def layernorm(p: Mapping, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics with the population variance, whatever the input dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(x.dtype)


def conv1d(
    p: Mapping, x: torch.Tensor, stride: int = 1, dtype=torch.float32, groups: int = 1,
    dilation: int = 1, keep_split: bool = False,
) -> torch.Tensor:
    """SAME conv. x: [B, T, C_in] → [B, ceil(T / stride), C_out]; weight
    [k, C_in//groups, C_out].

    Tensor parallel: a weight split on out-channels computes this rank's channels
    and gathers them (this rank's block only with `keep_split`, for a following
    row-parallel conv); a weight split on in-channels takes x's block of channels
    and all-reduces the partial sums before the bias.

    SAME padding is the JAX/XLA rule over the dilated kernel k_eff = (k - 1) *
    dilation + 1: total = max((ceil(T / stride) - 1) * stride + k_eff - T, 0), the
    smaller half on the left. For stride 1 that is k_eff - 1 (an even kernel at
    dilation 3 pads (k-1)*3 // 2 on the left, not (k//2 - 1) * 3); for stride 2 it
    depends on T's parity (k=5: (1, 2) for even T, (2, 2) for odd), so the pad is
    explicit."""
    split = tp.split_dim(p["w"])
    if split == 2:
        x, groups = _out_split_input(tp.copy(x), p["w"].shape[1], groups)
        y = _conv1d(p["w"], x, stride, dtype, groups, dilation) + p["b"].to(dtype)
        return y if keep_split else tp.gather(y)
    y = _conv1d(p["w"], x, stride, dtype, groups, dilation)
    if split == 1:
        if groups != 1:
            raise ValueError("an in-channel split needs an ungrouped conv")
        y = tp.reduce(y)
    return y + p["b"].to(dtype)


def _out_split_input(x: torch.Tensor, cin_group: int, groups: int):
    """(the input channels this rank's block of output channels reads, its group
    count). Ungrouped: all of them. Grouped: the whole groups the block covers when
    the rank count divides the groups, else the one group the block lies in."""
    if groups == 1:
        return x, 1
    n, r = tp.model_size(), tp.model_rank()
    if groups % n == 0:
        per = groups // n
        return x[..., r * per * cin_group : (r + 1) * per * cin_group], per
    if n % groups == 0:
        g = r // (n // groups)
        return x[..., g * cin_group : (g + 1) * cin_group], 1
    raise ValueError(f"{groups} conv groups cannot be split over {n} model ranks")


def _conv1d(w: torch.Tensor, x: torch.Tensor, stride: int, dtype, groups: int, dilation: int) -> torch.Tensor:
    """The SAME correlation of `conv1d`, without the bias."""
    k = w.shape[0]
    k_eff = (k - 1) * dilation + 1
    t = x.shape[1]
    total = max((-(-t // stride) - 1) * stride + k_eff - t, 0)
    lo = total // 2
    w = w.to(dtype).permute(2, 1, 0)  # [C_out, C_in/groups, k]
    xt = x.to(dtype).transpose(1, 2)
    if total == 2 * lo:  # symmetric: the conv pads, no copy
        y = F.conv1d(xt, w, stride=stride, padding=lo, groups=groups, dilation=dilation)
    else:
        y = F.conv1d(F.pad(xt, (lo, total - lo)), w, stride=stride, groups=groups, dilation=dilation)
    return y.transpose(1, 2)


def _nwc_weights(p: Mapping, dtype, transposed: bool = False):
    """(weight, bias) of a conv for the channels-last path, built once per (dtype,
    device) and kept on the parameter node (`cached_frozen`; `clear_derived` drops them):
    the weight cast to `dtype` and laid out as cuDNN's channels-last filter, C_in
    fastest for a conv ([C_out, C_in, 1, k] lying as [C_out, 1, k, C_in]), C_out
    fastest for a transposed conv ([C_in, C_out, 1, k] lying as [C_in, 1, k, C_out],
    its taps reversed as `conv1d_transpose` reverses them); the bias cast, or None
    where the node has none. A conv's output channels are zero-padded to a multiple
    of 8: cuDNN's NHWC kernels take channels in eights, and a 1-channel output (the
    last conv of a vocoder) came back through its nhwcToNchw conversion."""
    w = p["w"]

    def build():
        cast = w.to(dtype)
        if transposed:
            rows = cast.flip(0).permute(1, 0, 2)  # [C_in, k, C_out]
        else:
            rows = F.pad(cast.permute(2, 0, 1), (0, 0, 0, 0, 0, -w.shape[2] % 8))  # [C_out + pad, k, C_in]
        b = getattr(p, "b", None) if isinstance(p, nn.Module) else p.get("b")
        if b is not None and not transposed:
            b = F.pad(b, (0, -w.shape[2] % 8))
        return rows.contiguous().unsqueeze(1).permute(0, 3, 1, 2), None if b is None else b.to(dtype)

    return cached_frozen(p, ("conv_nwc", dtype, w.device, transposed), build)


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] contiguous seen as cuDNN's NCHW [B, C, 1, T]: strides (T·C, 1,
    T·C, C), channels-last, so cuDNN reads it as it lies."""
    return x.contiguous().transpose(1, 2).unsqueeze(2)


def _from_nchw(y: torch.Tensor) -> torch.Tensor:
    """A channels-last conv result [B, C, 1, T] as [B, T, C] (contiguous: a view)."""
    return y.squeeze(2).transpose(1, 2).contiguous()


def conv1d_nwc(p: Mapping, x: torch.Tensor, dtype=torch.float32, dilation: int = 1,
               bias: bool = True) -> torch.Tensor:
    """`conv1d(p, x, dilation=dilation, dtype=dtype)` (stride 1, ungrouped, an
    unsharded weight) with every activation channels-last: x [B, T, C_in] is read
    as it lies, the weight is `_nwc_weights`' and the result [B, T, C_out] comes
    back contiguous (C_out a multiple of 8; else a view of the padded channels), so
    cuDNN runs its NHWC kernels with no layout conversion at either end.
    `bias=False` leaves the bias to the caller (the activation after the conv adds
    it as it loads). Each call adds one to `ops.counter("conv_nwc")`."""
    w, b = _nwc_weights(p, dtype)
    k = w.shape[3]
    total = (k - 1) * dilation
    lo = total // 2
    x = x.to(dtype)
    if total != 2 * lo:  # an even kernel at an odd dilation: SAME pads one more on the right
        x = F.pad(x, (0, 0, lo, total - lo))
        lo = 0
    y = F.conv2d(_as_nchw(x), w, b if bias else None, padding=(0, lo), dilation=(1, dilation))
    _NWC.count += 1
    return _from_nchw(y)[..., : p["w"].shape[2]]


def conv1d_transpose_nwc(p: Mapping, x: torch.Tensor, stride: int, dtype=torch.float32) -> torch.Tensor:
    """`conv1d_transpose(p, x, stride, dtype)` less its bias (left to the caller),
    channels-last as `conv1d_nwc`: x [B, T, C_in] → [B, T · stride, C_out]
    contiguous. Counted in `conv_nwc`."""
    w, _ = _nwc_weights(p, dtype, transposed=True)
    pad = (w.shape[3] - stride) // 2
    y = F.conv_transpose2d(_as_nchw(x.to(dtype)), w, stride=(1, stride), padding=(0, pad))
    _NWC.count += 1
    return _from_nchw(y[..., : x.shape[1] * stride])


def conv1d_phased(p: Mapping, x: torch.Tensor, dilation: int, dtype=torch.float32) -> torch.Tensor:
    """`conv1d_nwc(p, x, dtype, dilation, bias=False)` for an odd kernel, computed as
    one undilated conv over the row's d = `dilation` interleaved phases: output t =
    u·d + r is Σ_j w_j · x_pad[(u + j)·d + r], so the same k taps, undilated over
    phase r of the padded row, give the outputs of phase r. The same products and
    sums, in the shape cuDNN runs on the tensor cores where, given some wide dilated
    convs, it picks a CUDA-core kernel.

    The padding is `_conv1d`'s SAME rule at stride 1, (k - 1)·d // 2 on the left,
    which for an odd k is a = (k - 1) / 2 whole phase rows. x [B, T, C] is read once
    into the phases, channels-last [B·d, a + ceil(T / d) + a, C], only the pads
    zeroed, and the conv's result written once as [B, T, C_out] contiguous; the bias
    is left to the caller. Each call adds one to `ops.counter("conv_phased")` (a
    cuDNN conv, no hand kernel) and one to `conv_nwc`."""
    w, _ = _nwc_weights(p, dtype)
    k, c_out, d = w.shape[3], p["w"].shape[2], dilation
    if k % 2 == 0 or tp.split_dim(p["w"]) is not None:
        raise ValueError(f"the phase split takes an odd kernel of an unsharded weight (k={k})")
    x = x.to(dtype)
    n, t, c = x.shape
    a = (k - 1) // 2
    q, rem = divmod(t, d)  # whole phase rows of x, and the samples of its last, partial one
    v = q + (rem > 0)  # outputs a phase
    rows = x.new_empty((n, d, v + 2 * a, c))
    rows[:, :, :a].zero_()
    rows[:, :, a + q:].zero_()
    rows[:, :, a : a + q] = x[:, : q * d].unflatten(1, (q, d)).transpose(1, 2)
    if rem:
        rows[:, :rem, a + q] = x[:, q * d :]
    y = _from_nchw(F.conv2d(_as_nchw(rows.view(n * d, -1, c)), w)).view(n, d, v, -1)[..., :c_out]
    out = y.new_empty((n, t, c_out))
    out[:, : q * d].unflatten(1, (q, d)).copy_(y[:, :, :q].transpose(1, 2))
    if rem:
        out[:, q * d :] = y[:, :rem, q]
    _PHASED.count += 1
    _NWC.count += 1
    return out


def conv1d_transpose(p: Mapping, x: torch.Tensor, stride: int, dtype=torch.float32) -> torch.Tensor:
    """Transposed conv, output length exactly T * stride (the HiFi-GAN upsampler).

    The JAX package's `lax.conv_transpose` (no `transpose_kernel`) zero-stuffs x,
    pads k - 1 - p with p = (k - stride) // 2 and correlates with the kernel as
    stored. `F.conv_transpose1d` correlates with the kernel reversed (it is the
    adjoint of a correlation), so the taps are flipped here; without the flip the
    result is silently another function. The bias is added after the slice."""
    kernel = p["w"].shape[0]
    pad = (kernel - stride) // 2
    w = p["w"].to(dtype).flip(0).permute(1, 2, 0)  # [C_in, C_out, k], taps reversed
    y = F.conv_transpose1d(x.to(dtype).transpose(1, 2), w, stride=stride, padding=pad)
    return y[:, :, : x.shape[1] * stride].transpose(1, 2) + p["b"].to(dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def sinusoidal_positions(length: int, dim: int, dtype=np.float32) -> np.ndarray:
    """Standard transformer sinusoidal position table [length, dim] (host-computed)."""
    pos = np.arange(length)[:, None].astype(np.float64)
    i = np.arange(dim // 2)[None, :].astype(np.float64)
    angles = pos / np.power(10000.0, 2 * i / dim)
    table = np.zeros((length, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(angles)
    table[:, 1::2] = np.cos(angles)
    return table.astype(dtype)


_CONSTANTS: dict = {}


def device_constant(key, build, device) -> torch.Tensor:
    """`build()`, a numpy array, copied to `device` once per (key, device) and kept.

    A pass then copies nothing from the host, which a CUDA graph's capture forbids.
    Made outside inference mode whatever the caller's mode: serving may build it
    first, and an inference tensor cannot enter a later training step's graph."""
    full = (key, torch.device(device))
    if full not in _CONSTANTS:
        with torch.inference_mode(False):
            _CONSTANTS[full] = torch.as_tensor(build(), device=device)
    return _CONSTANTS[full]


def positions_on(length: int, dim: int, device) -> torch.Tensor:
    """`sinusoidal_positions(length, dim)` (f32) on `device`, built once."""
    return device_constant(("sinusoidal_positions", length, dim), lambda: sinusoidal_positions(length, dim), device)


# ---------------------------------------------------------------- attention


def mha_init(g: torch.Generator, dim: int) -> Tree:
    return group(**{k: dense_init(g, dim, dim) for k in ("q", "k", "v", "o")})


def mha(
    p: Mapping, x: torch.Tensor, n_heads: int, mask: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Self-attention. x: [B, T, D]; mask: [B, T] (1 = valid), a -1e9 key bias.
    With q/k/v split over 'model' this rank runs its whole heads (n_heads / n_model)."""
    b, t, d = x.shape
    dh = d // n_heads
    q, k, v, whole_heads = _qkv(p, x, dtype, dh)
    q, k, v = (a.reshape(b, t, -1, dh) for a in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    if mask is not None:
        logits = logits + torch.where(mask[:, None, None, :] != 0, 0.0, NEG)
    attn = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, -1)
    return dense(p["o"], out if whole_heads else tp.scatter(out), dtype)


def _qkv(p: Mapping, x: torch.Tensor, dtype, dh: int):
    """(q, k, v, whole_heads). Column-parallel projections give this rank's block of
    columns; when that block is not a whole number of heads (n_heads not a multiple
    of the model ranks) they are gathered, attention runs every head, and the caller
    scatters its output back to the block the row-parallel `o` reads."""
    q, k, v = (dense(p[n], x, dtype) for n in ("q", "k", "v"))
    if tp.split_dim(p["q"]["w"]) is None or q.shape[-1] % dh == 0:
        return q, k, v, True
    return tp.gather(q), tp.gather(k), tp.gather(v), False


def with_neighbors(arr: torch.Tensor) -> torch.Tensor:
    """[B, nb, w, ...] → [B, nb, 3w, ...]: previous, own and next block, zero-edged."""
    zero = torch.zeros_like(arr[:, :1])
    prev = torch.cat([zero, arr[:, :-1]], dim=1)
    nxt = torch.cat([arr[:, 1:], zero], dim=1)
    return torch.cat([prev, arr, nxt], dim=2)


def local_mha(
    p: Mapping,
    x: torch.Tensor,
    n_heads: int,
    window: int,
    mask: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Blocked local self-attention: each block of `window` queries attends to its
    own block and both neighbours (span 3*window). Equals full attention when
    T <= 2*window; in (2w, 3w] the two differ. x: [B, T, D] with T % window == 0."""
    b, t, d = x.shape
    if t % window != 0:
        raise ValueError(f"T={t} must be a multiple of window={window}")
    dh = d // n_heads
    nb = t // window
    q, k, v, whole_heads = _qkv(p, x, dtype, dh)
    q = q.reshape(b, nb, window, -1, dh)
    k = with_neighbors(k.reshape(b, nb, window, -1, dh))
    v = with_neighbors(v.reshape(b, nb, window, -1, dh))
    logits = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) / math.sqrt(dh)
    key_mask = torch.ones((b, t), device=x.device) if mask is None else mask.float()
    km = with_neighbors(key_mask.reshape(b, nb, window))  # [B, nb, 3w]
    logits = logits + torch.where(km[:, :, None, None, :] != 0, 0.0, NEG)
    attn = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", attn, v).reshape(b, t, -1)
    return dense(p["o"], out if whole_heads else tp.scatter(out), dtype)


# ---------------------------------------------------------------- transformer block


def transformer_block_init(
    g: torch.Generator, dim: int, n_heads: int, d_ff: int, conv_kernel: int = 3
) -> Tree:
    return group(
        ln1=layernorm_init(dim),
        attn=mha_init(g, dim),
        ln2=layernorm_init(dim),
        ff1=conv1d_init(g, dim, d_ff, conv_kernel),
        ff2=conv1d_init(g, d_ff, dim, conv_kernel),
    )


def uses_local_attention(window: Optional[int], t: int) -> bool:
    """Local attention only when 2*window < T: for T <= 2w block-local equals full
    attention, and in (2w, 3w] the two differ, so the choice must be exactly this."""
    return window is not None and 2 * window < t


def transformer_block(
    p: Mapping, x: torch.Tensor, n_heads: int, mask: Optional[torch.Tensor] = None,
    dtype=torch.float32, attention_window: Optional[int] = None,
) -> torch.Tensor:
    """Pre-LN block; `mask` [B, T] zeroes padded positions between sublayers."""
    mask_f = None if mask is None else mask[..., None].to(x.dtype)
    normed = layernorm(p["ln1"], x)
    if uses_local_attention(attention_window, x.shape[1]):
        attended = local_mha(p["attn"], normed, n_heads, attention_window, mask, dtype)
    else:
        attended = mha(p["attn"], normed, n_heads, mask, dtype)
    h = x + attended
    if mask_f is not None:
        h = h * mask_f
    y = layernorm(p["ln2"], h)
    y = torch.relu(conv1d(p["ff1"], y, dtype=dtype, keep_split=True))
    y = conv1d(p["ff2"], y, dtype=dtype)
    out = h + y
    if mask_f is not None:
        out = out * mask_f
    return out


class TransformerStack(Tree):
    """`{"blocks": [...], "ln_out": ...}`: L pre-LN blocks and a final LayerNorm."""

    def __init__(
        self, g: torch.Generator, n_layers: int, dim: int, n_heads: int, d_ff: int,
        conv_kernel: int = 3,
    ):
        super().__init__()
        self.n_heads = n_heads
        self.blocks = nn.ModuleList(
            transformer_block_init(g, dim, n_heads, d_ff, conv_kernel) for _ in range(n_layers)
        )
        self.ln_out = layernorm_init(dim)

    def forward(self, x, mask=None, dtype=torch.float32, attention_window=None):
        return transformer_stack(self, x, self.n_heads, mask, dtype, attention_window)


def cached(node, key, build):
    """`build()` memoized on a parameter module under `key` (plain dicts: no memo).

    Kernels take weights re-laid-out (stacked over layers, cast to the compute
    dtype); serving builds that once per (dtype, device). Serving never writes its
    parameters; code that updates them in place drops the memos with
    `clear_derived` (the trainer does, after every optimizer step)."""
    if not isinstance(node, nn.Module):
        return build()
    memo = node.__dict__.setdefault("_derived", {})
    if key not in memo:
        memo[key] = build()
    return memo[key]


def cached_frozen(node, key, build):
    """`cached` in a pass that takes no gradient of `node`'s parameters, and built
    afresh in one that does, so that it stays on the autograd graph: a memo built
    under `no_grad` (a critic's step runs the generator so) would cut the
    generator's own step off from its weights."""
    if torch.is_grad_enabled() and isinstance(node, nn.Module) and any(v.requires_grad for v in node.parameters()):
        return build()
    return cached(node, key, build)


def clear_derived(module: nn.Module) -> None:
    """Drop every `cached` memo under `module`: its parameters changed in place."""
    for m in module.modules():
        m.__dict__.pop("_derived", None)


def transformer_stack(
    p: Mapping, x: torch.Tensor, n_heads: int, mask: Optional[torch.Tensor] = None,
    dtype=torch.float32, attention_window: Optional[int] = None,
) -> torch.Tensor:
    for blk in p["blocks"]:
        x = transformer_block(blk, x, n_heads, mask, dtype, attention_window)
    return layernorm(p["ln_out"], x)
