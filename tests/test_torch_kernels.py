"""The port's kernel wrappers: plain PyTorch versions vs the JAX Pallas kernels.

The Pallas kernels run in interpret mode with bf16=False, as tests/test_kernels.py
runs them; the port's wrappers, given CPU tensors, run their plain versions.
Tolerance atol 5e-5 / rtol 1e-4 (f32, another summation order). The CUDA kernels
themselves are held against the plain versions only where a card is present
(tests/test_torch_cuda.py) and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.config import ModelConfig
from gonova_tts_tpu.models import layers as jl
from gonova_tts_tpu.models import vocos as jvocos
from gonova_tts_tpu.ops.transformer_stack_kernel import stack_block_params, transformer_stack_pallas
from gonova_tts_tpu.ops.vocos_stack_kernel import vocos_stack_pallas
from gonova_tts_tpu_torch import ops
from gonova_tts_tpu_torch.models import layers as tl
from gonova_tts_tpu_torch.ops import transformer_stack as ts_op
from gonova_tts_tpu_torch.ops import vocos_stack as vs_op


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores: torch's own thread pool (8 spinning
    threads per worker) would starve the other workers' tests."""
    torch.set_num_threads(1)


ATOL, RTOL = 5e-5, 1e-4


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


@pytest.fixture(scope="module")
def tstack():
    d, h, f, l = 64, 4, 128, 2
    return jl.transformer_stack_init(jax.random.PRNGKey(0), l, d, h, f, 3), d, h


@pytest.mark.parametrize(
    "b,t,lengths,window",
    [
        (4, 32, [32, 20, 7, 32], None),  # full attention
        (2, 128, [128, 77], 16),  # block-local attention
        (2, 32, [32, 17], 16),  # window >= T/2: full attention on both sides
        (2, 48, [48, 31], 16),  # T in (2w, 3w]: local
    ],
)
def test_transformer_stack_plain_matches_pallas(tstack, rng, b, t, lengths, window):
    p, d, h = tstack
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = (np.arange(t)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    x = x * mask[..., None]
    ref = transformer_stack_pallas(
        jnp.asarray(x), jnp.asarray(mask), stack_block_params(p["blocks"], h),
        p["ln_out"]["g"], p["ln_out"]["b"], h, window=window, interpret=True, bf16=False,
    )
    packed = ts_op.pack_params(to_torch(p), torch.float32)
    ours = ts_op.transformer_stack(torch.as_tensor(x), torch.as_tensor(mask), packed, h, window=window)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    # In f32 the plain version is the plain layer stack.
    layered = tl.transformer_stack(
        to_torch(p), torch.as_tensor(x), h, torch.as_tensor(mask), attention_window=window
    )
    np.testing.assert_allclose(ours.numpy(), layered.numpy(), atol=ATOL, rtol=RTOL)


def test_transformer_stack_local_takes_any_mask(tstack, rng):
    """The port reads each key's mask, so a non-prefix mask on the local path
    gives layers.local_mha's answer (the Pallas kernel assumed prefix masks)."""
    p, d, h = tstack
    x = torch.as_tensor(rng.standard_normal((1, 64, d)).astype(np.float32))
    mask = torch.ones((1, 64))
    mask[0, 10:20] = 0.0
    packed = ts_op.pack_params(to_torch(p), torch.float32)
    ours = ts_op.transformer_stack(x * mask[..., None], mask, packed, h, window=16)
    ref = tl.transformer_stack(to_torch(p), x * mask[..., None], h, mask, attention_window=16)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


def test_transformer_stack_bf16_plain_stays_close(tstack, rng):
    """The bf16 staging stays within bf16-scale error of f32."""
    p, d, h = tstack
    x = torch.as_tensor(rng.standard_normal((2, 64, d)).astype(np.float32))
    mask = torch.ones((2, 64))
    f32 = ts_op.transformer_stack(x, mask, ts_op.pack_params(to_torch(p), torch.float32), h)
    bf = ts_op.transformer_stack(x, mask, ts_op.pack_params(to_torch(p), torch.bfloat16), h, bf16=True)
    assert bf.dtype == torch.bfloat16
    assert float((bf.float() - f32).abs().max()) < 0.15


@pytest.fixture(scope="module")
def vstack():
    cfg = ModelConfig(vocos_dim=128, vocos_ff=256, vocos_layers=2)
    return jvocos.init(jax.random.PRNGKey(2), cfg)


def _stacked(blocks):
    keys = [("dw",), ("dw_b",), ("ln", "g"), ("ln", "b"), ("pw1", "w"), ("pw1", "b"),
            ("pw2", "w"), ("pw2", "b"), ("gamma",)]

    def get(b, path):
        for k in path:
            b = b[k]
        return b

    return [jnp.stack([get(b, k) for b in blocks]) for k in keys]


@pytest.mark.parametrize("b,t", [(2, 50), (1, 122)])
def test_vocos_stack_plain_matches_pallas(vstack, rng, b, t):
    x = rng.standard_normal((b, t, 128)).astype(np.float32)
    ref = vocos_stack_pallas(jnp.asarray(x), *_stacked(vstack["blocks"]), interpret=True, bf16=False)
    packed = vs_op.pack_params(to_torch(vstack)["blocks"], torch.float32)
    ours = vs_op.vocos_stack(torch.as_tensor(x), packed)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    # In f32 the plain version is the plain block loop.
    from gonova_tts_tpu_torch.models import vocos as tvocos

    y = torch.as_tensor(x)
    for blk in to_torch(vstack)["blocks"]:
        y = tvocos._block_apply(blk, y, torch.float32)
    np.testing.assert_allclose(ours.numpy(), y.numpy(), atol=ATOL, rtol=RTOL)


def test_wrappers_count_only_kernel_launches(tstack, rng):
    """CPU tensors take the plain version, which is not a launch."""
    p, d, h = tstack
    ops.reset_launch_counts()
    x = torch.as_tensor(rng.standard_normal((1, 32, d)).astype(np.float32))
    ts_op.transformer_stack(x, torch.ones((1, 32)), ts_op.pack_params(to_torch(p), torch.float32), h)
    assert ops.launch_counts()["transformer_stack"] == 0

