"""Port layers (gonova_tts_tpu_torch.models.layers) vs the JAX layers, f32 on the CPU.

Both sides get the same seeded JAX parameter tree and the same numpy inputs.
Tolerance: atol 2e-5 / rtol 1e-4 — f32 with a different summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.models import layers as jl
from gonova_tts_tpu_torch.models import layers as tl


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores: torch's own thread pool (8 spinning
    threads per worker) would starve the other workers' tests."""
    torch.set_num_threads(1)


ATOL, RTOL = 2e-5, 1e-4


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def close(ours, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def prefix_mask(lengths, t):
    return (np.arange(t)[None] < np.asarray(lengths)[:, None]).astype(np.float32)


def test_dense_embedding_layernorm_conv(rng):
    x = rng.standard_normal((2, 9, 16)).astype(np.float32) * 3 + 1
    d = jl.dense_init(jax.random.PRNGKey(0), 16, 24)
    close(tl.dense(to_torch(d), torch.as_tensor(x)), jl.dense(d, jnp.asarray(x)))
    ln = {"g": jnp.asarray(rng.standard_normal(16), jnp.float32), "b": jnp.asarray(rng.standard_normal(16), jnp.float32)}
    close(tl.layernorm(to_torch(ln), torch.as_tensor(x)), jl.layernorm(ln, jnp.asarray(x)))
    for k in (3, 5, 7):
        c = jl.conv1d_init(jax.random.PRNGKey(k), 16, 8, k)
        close(tl.conv1d(to_torch(c), torch.as_tensor(x)), jl.conv1d(c, jnp.asarray(x)))
    e = jl.embedding_init(jax.random.PRNGKey(1), 30, 16)
    ids = rng.integers(0, 30, (2, 7)).astype(np.int32)
    close(tl.embedding(to_torch(e), torch.as_tensor(ids).long()), jl.embedding(e, jnp.asarray(ids)))
    np.testing.assert_array_equal(tl.sinusoidal_positions(50, 16), jl.sinusoidal_positions(50, 16))


def test_tiled_matmul_and_dense_tiled_match_jax(rng):
    x = rng.standard_normal((2, 150, 16)).astype(np.float32)
    d = jl.dense_init(jax.random.PRNGKey(0), 16, 24)
    close(tl.dense(to_torch(d), torch.as_tensor(x), tiled=True), jl.dense(d, jnp.asarray(x)))
    w = torch.as_tensor(rng.standard_normal((16, 24)).astype(np.float32))
    np.testing.assert_allclose(tl.tiled_matmul(torch.as_tensor(x), w).numpy(), x @ w.numpy(), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("rows,start", [(122, 35), (100, 0), (7, 250)])
def test_tiled_rows_do_not_depend_on_the_call_shape(rng, rows, start):
    """A window's rows of the tiled product equal the same rows of a longer call
    bit for bit."""
    x = torch.as_tensor(rng.standard_normal((1, 512, 96)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((96, 200)).astype(np.float32))
    sl = slice(start, start + rows)
    assert torch.equal(tl.tiled_matmul(x, w)[:, sl], tl.tiled_matmul(x[:, sl].clone(), w))


@pytest.mark.parametrize(
    "t,window,lengths",
    [
        (32, None, [32, 20]),  # full attention, a padded row
        (48, 16, [48, 30]),  # T in (2w, 3w]: local and full differ here
        (128, 16, [128, 77]),  # T > 3w
        (32, 16, [32, 17]),  # T <= 2w: the block dispatch picks full attention
    ],
)
def test_attention_and_block(rng, t, window, lengths):
    d, h = 32, 4
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    mask = prefix_mask(lengths, t)
    p = jl.mha_init(jax.random.PRNGKey(3), d)
    pt = to_torch(p)
    xt, mt = torch.as_tensor(x), torch.as_tensor(mask)
    close(tl.mha(pt, xt, h, mt), jl.mha(p, jnp.asarray(x), h, jnp.asarray(mask)))
    if window is not None and t % window == 0:
        close(
            tl.local_mha(pt, xt, h, window, mt),
            jl.local_mha(p, jnp.asarray(x), h, window, jnp.asarray(mask)),
        )
    blk = jl.transformer_block_init(jax.random.PRNGKey(4), d, h, 64, 3)
    close(
        tl.transformer_block(to_torch(blk), xt, h, mt, attention_window=window),
        jl.transformer_block(blk, jnp.asarray(x), h, jnp.asarray(mask), attention_window=window),
        atol=5e-5,
    )


def test_local_differs_from_full_in_2w_3w(rng):
    """The (2w, 3w] case is a real difference, so the dispatch threshold matters."""
    d, h, w, t = 32, 4, 16, 48
    p = to_torch(jl.mha_init(jax.random.PRNGKey(5), d))
    x = torch.as_tensor(rng.standard_normal((1, t, d)).astype(np.float32))
    assert not torch.allclose(tl.local_mha(p, x, h, w), tl.mha(p, x, h), atol=1e-3)
    assert tl.uses_local_attention(w, 3 * w) and not tl.uses_local_attention(w, 2 * w)


def test_transformer_stack_masked(rng):
    d, h = 32, 4
    p = jl.transformer_stack_init(jax.random.PRNGKey(6), 2, d, h, 64, 3)
    x = rng.standard_normal((3, 64, d)).astype(np.float32)
    mask = prefix_mask([64, 40, 5], 64)
    x = x * mask[..., None]
    for window in (None, 16):
        ref = jl.transformer_stack(p, jnp.asarray(x), h, jnp.asarray(mask), attention_window=window)
        ours = tl.transformer_stack(to_torch(p), torch.as_tensor(x), h, torch.as_tensor(mask), attention_window=window)
        close(ours, ref, atol=5e-5)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 2, 5, 13, 40])
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_phase_split_conv_equals_the_dilated_conv(k, d, t, b):
    """`conv1d_phased` is `conv1d(..., dilation=d)` in f32 (the same products, summed
    per phase) less the bias, which it leaves to the caller, for T odd, even and
    shorter than the dilated kernel; x lies as [B, T, C] (what the AMP block's
    activation returns) and the result is [B, T, C_out] contiguous (6 output
    channels: the filter runs zero-padded to 8), and each call counts one
    `conv_phased`."""
    from gonova_tts_tpu_torch import ops

    g = torch.Generator().manual_seed(1000 * k + 100 * d + 10 * t + b)
    p = {"w": torch.randn((k, 5, 6), generator=g), "b": torch.randn(6, generator=g)}
    x = torch.randn((b, t, 5), generator=g)
    before = ops.launch_counts()["conv_phased"]
    got = tl.conv1d_phased(p, x, d)
    assert ops.launch_counts()["conv_phased"] == before + 1
    assert got.shape == (b, t, 6) and got.is_contiguous()
    torch.testing.assert_close(got + p["b"], tl.conv1d(p, x, dilation=d), rtol=1e-5, atol=2e-5)
