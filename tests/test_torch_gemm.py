"""The shared bf16 tensor-core GEMM of the port (`ops/gemm_tc.py`), on the CPU.

The kernel itself runs only on a card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
Here: (a) its plain version in f32 against the JAX package's `layers.conv1d` k=3
SAME, `layers.dense` and the Vocos block's MLP half, on the same numpy inputs made
from a seed, max |difference| <= 1e-5 (f32, another summation order); (b) the tile
and split planner, which is pure Python so that it can be pinned without a card;
(c) the [N, K] weight copies `pack_params` stores for the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.models import layers as jl
from gonova_tts_tpu_torch import ops
from gonova_tts_tpu_torch.config import ModelConfig
from gonova_tts_tpu_torch.models import tts
from gonova_tts_tpu_torch.ops import gemm_tc as g
from gonova_tts_tpu_torch.ops import transformer_stack as ts_op
from gonova_tts_tpu_torch.ops import vocos_stack as vs_op


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores."""
    torch.set_num_threads(1)


TOL = 1e-5
EPILOGUES = [g.EPI_BIAS, g.EPI_BIAS_RELU, g.EPI_RESID_MASK, g.EPI_GELU, g.EPI_GAMMA_RESID, g.EPI_GELU_F32]
LENGTHS = [1, 50, 64, 122]


def inputs(rng, t, cin, n, taps, b=2):
    k = taps * cin
    lengths = np.maximum(1, t - np.arange(b) * (t // 3))
    return dict(
        a=rng.standard_normal((b, t, cin)).astype(np.float32),
        w=(rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
        bias=rng.standard_normal(n).astype(np.float32),
        resid=rng.standard_normal((b, t, n)).astype(np.float32),
        mask=(np.arange(t)[None] < lengths[:, None]).astype(np.float32),
        gamma=rng.standard_normal(n).astype(np.float32),
    )


def ours(x, epi, taps):
    tt = {k: torch.as_tensor(v) for k, v in x.items()}
    return g.gemm_tc(tt["a"], tt["w"], epi, tt["bias"], tt["resid"], tt["mask"], tt["gamma"], taps).numpy()


def jax_epilogue(v, x, epi):
    if epi == g.EPI_BIAS:
        return v
    if epi == g.EPI_BIAS_RELU:
        return jax.nn.relu(v)
    if epi == g.EPI_RESID_MASK:
        return (jnp.asarray(x["resid"]) + v) * jnp.asarray(x["mask"])[..., None]
    if epi in (g.EPI_GELU, g.EPI_GELU_F32):
        return jax.nn.gelu(v)
    return jnp.asarray(x["resid"]) + v * jnp.asarray(x["gamma"])


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("epi", EPILOGUES)
def test_conv3_plain_matches_jax_conv1d(rng, epi, t):
    """A_CONV3: the k=3 SAME conv as one product over K = 3 * Cin, zero edges per sequence."""
    x = inputs(rng, t, 64, 128, taps=3)
    p = {"w": jnp.asarray(x["w"].reshape(3, 64, 128)), "b": jnp.asarray(x["bias"])}
    ref = jax_epilogue(jl.conv1d(p, jnp.asarray(x["a"])), x, epi)
    assert float(np.abs(ours(x, epi, 3) - np.asarray(ref)).max()) <= TOL


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("epi", EPILOGUES)
def test_rows_plain_matches_jax_dense(rng, epi, t):
    x = inputs(rng, t, 128, 192, taps=1)
    ref = jax_epilogue(jl.dense({"w": jnp.asarray(x["w"]), "b": jnp.asarray(x["bias"])}, jnp.asarray(x["a"])), x, epi)
    assert float(np.abs(ours(x, epi, 1) - np.asarray(ref)).max()) <= TOL


@pytest.mark.parametrize("t", LENGTHS)
def test_rows_gelu_then_gamma_resid_is_the_vocos_mlp_half(rng, t):
    """EPI_GELU then EPI_GAMMA_RESID chained: x + gamma * (gelu(n @ w1 + b1) @ w2 + b2),
    the MLP half of the JAX package's `vocos._block_apply`."""
    c, f = 64, 192
    x1, x2 = inputs(rng, t, c, f, taps=1), inputs(rng, t, f, c, taps=1)
    pw1 = {"w": jnp.asarray(x1["w"]), "b": jnp.asarray(x1["bias"])}
    pw2 = {"w": jnp.asarray(x2["w"]), "b": jnp.asarray(x2["bias"])}
    h = jl.dense(pw2, jax.nn.gelu(jl.dense(pw1, jnp.asarray(x1["a"]))))
    ref = jnp.asarray(x2["resid"]) + h * jnp.asarray(x2["gamma"])
    x2["a"] = ours(x1, g.EPI_GELU, 1)
    assert float(np.abs(ours(x2, g.EPI_GAMMA_RESID, 1) - np.asarray(ref)).max()) <= TOL


def test_gelu_f32_rounds_only_the_result_and_f32_output_keeps_an_f32_residual(rng):
    """bf16 operands: EPI_GELU gives bf16(gelu(bf16(v))), EPI_GELU_F32 bf16(gelu(v));
    EPI_GAMMA_RESID with a float32 output reads an f32 resid and adds v * gamma unrounded."""
    x = {k: torch.as_tensor(v) for k, v in inputs(rng, 50, 64, 128, taps=1).items()}
    a, w = x["a"].bfloat16(), x["w"].bfloat16()
    v = a.float() @ w.float() + x["bias"]
    gelu = lambda u: torch.nn.functional.gelu(u, approximate="tanh")  # noqa: E731
    assert torch.equal(g.gemm_tc(a, w, g.EPI_GELU_F32, x["bias"]), gelu(v).bfloat16())
    assert torch.equal(g.gemm_tc(a, w, g.EPI_GELU, x["bias"]), gelu(v.bfloat16().float()).bfloat16())
    out = g.gemm_tc(a, w, g.EPI_GAMMA_RESID, x["bias"], resid=x["resid"], gamma=x["gamma"], out_dtype=torch.float32)
    assert out.dtype == torch.float32 and torch.equal(out, x["resid"] + v * x["gamma"])
    out = g.gemm_tc(a, w, g.EPI_BIAS, x["bias"], out_dtype=torch.float32)
    assert out.dtype == torch.float32 and torch.equal(out, v)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(rng):
    ops.reset_launch_counts()
    ours(inputs(rng, 8, 64, 64, taps=1), g.EPI_BIAS, 1)
    assert ops.launch_counts()["gemm_tc"] == 0


# ------------------------------------------------------------------ the planner

# (N, K, taps) of every product: the demo checkpoint (d_model 256, d_ff 1024, Vocos
# 512/1536) and the small test model (d_model 64, d_ff 128, Vocos 128/256).
PRODUCTS = [
    (768, 256, 1), (256, 256, 1), (1024, 768, 3), (256, 3072, 3), (1536, 512, 1), (512, 1536, 1),
    (192, 64, 1), (64, 64, 1), (128, 192, 3), (64, 384, 3), (256, 128, 1), (128, 256, 1),
]
ROW_COUNTS = [64, 256, 1280, 8192]


@pytest.mark.parametrize("n,k,taps", PRODUCTS)
def test_split_covers_k_once_and_ignores_m(n, k, taps):
    ranges = g.k_ranges(n, k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # no gap, no overlap
    assert all(lo % g.BK == 0 and hi % g.BK == 0 and hi > lo for lo, hi in ranges)
    assert len({hi - lo for lo, hi in ranges}) == 1  # the kernel walks equal parts
    # No K tile spans two conv taps: a tap's width is a whole number of tiles.
    assert not g.problems(k // taps, n, taps) and (k // taps) % g.BK == 0
    # The split is a function of (N, K) alone: the same at every row count and batch.
    plans = [g.plan(1, m, n, k) for m in ROW_COUNTS] + [g.plan(4, m // 4, n, k) for m in ROW_COUNTS]
    assert {p[2] for p in plans} == {g.split_k(n, k)} == {len(ranges)}
    assert all(p[:2] in g.TILES for p in plans)


def test_split_only_where_the_output_is_narrow_and_k_is_long():
    assert g.split_k(256, 3072) == 3  # conv-FFN2: 48 K tiles in three parts of 16
    assert all(g.split_k(n, k) == 1 for n, k in [(768, 256), (256, 256), (1024, 768), (1536, 512), (512, 1536)])
    assert g.split_k(1536, 3072) == 1  # wide enough to fill the card through its N tiles


@pytest.mark.parametrize("m,n,k,tile", [
    (8192, 1536, 512, (2, 128)), (8192, 1024, 768, (2, 128)),  # two 128 x 128 blocks an SM and more
    (1280, 1536, 512, (1, 128)), (2048, 256, 3072, (1, 128)), (64, 256, 256, (1, 128)),
    (8192, 64, 384, (1, 64)),  # an output no wider than 64 columns
])
def test_plan_picks_the_tile_the_sweep_found_best(m, n, k, tile):
    assert g.plan(1, m, n, k)[:2] == tile


def test_problems_lists_what_the_kernel_does_not_take():
    assert any("multiple of 64" in p for p in g.problems(96, 128))
    assert any("multiple of 8" in p for p in g.problems(64, 100))
    assert g.problems(64, 128, taps=2) and not g.problems(1024, 256, taps=3)


# ------------------------------------------------------------------ the packed weights


@pytest.fixture(scope="module")
def small_model():
    cfg = ModelConfig(d_model=64, n_heads=4, d_ff=128, encoder_layers=2, decoder_layers=2,
                      vocos_dim=128, vocos_ff=256, vocos_layers=2)
    return tts.TTS(cfg, torch.Generator().manual_seed(0))


def test_transformer_pack_adds_the_transposed_copies_for_bf16_only(small_model):
    f32 = ts_op.pack_params(small_model.acoustic.encoder, torch.float32)
    bf = ts_op.pack_params(small_model.acoustic.encoder, torch.bfloat16)
    assert not any(k.endswith("_t") for k in f32)
    for k, shape in (("wqkv", (2, 192, 64)), ("wo", (2, 64, 64)), ("w1", (2, 128, 192)), ("w2", (2, 64, 384))):
        wt = bf[k + "_t"]
        assert wt.shape == shape and wt.is_contiguous() and wt.dtype == torch.bfloat16
        assert torch.equal(wt, bf[k].reshape(2, -1, bf[k].shape[-1]).transpose(1, 2))
    assert [tuple(p) for p in ts_op.tc_plans(4, 512, 256, 1024)] == [
        g.plan(1, 2048, 768, 256), g.plan(1, 2048, 256, 256), g.plan(4, 512, 1024, 768), g.plan(4, 512, 256, 3072),
    ]


def test_vocos_pack_adds_the_transposed_copies_for_bf16_only(small_model):
    f32 = vs_op.pack_params(small_model.vocoder.blocks, torch.float32)
    bf = vs_op.pack_params(small_model.vocoder.blocks, torch.bfloat16)
    assert not any(k.endswith("_t") for k in f32)
    for k, shape in (("w1", (2, 256, 128)), ("w2", (2, 128, 256))):
        assert bf[k + "_t"].shape == shape and bf[k + "_t"].is_contiguous()
        assert torch.equal(bf[k + "_t"], bf[k].transpose(1, 2))
    assert [tuple(p) for p in vs_op.tc_plans(4, 320, 512, 1536)] == [
        g.plan(1, 1280, 1536, 512), g.plan(1, 1280, 512, 1536),
    ]
