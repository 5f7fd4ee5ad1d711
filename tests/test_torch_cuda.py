"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Needs a CUDA device and nvcc, and no JAX (the machine with the card has none), so
run it without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Elsewhere every case skips. Tolerances: f32 2e-3 (summation order through a
4-layer stack), bf16 0.1 (a one-ulp difference at a bf16 rounding point, about
0.4%, carried through the later layers).
"""

import numpy as np
import pytest
import torch

from gonova_tts_tpu_torch import ops
from gonova_tts_tpu_torch.config import ModelConfig
from gonova_tts_tpu_torch.models import tts
from gonova_tts_tpu_torch.ops import transformer_stack as ts_op
from gonova_tts_tpu_torch.ops import vocos_stack as vs_op


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gonova_tts_tpu_torch.device import resolve_device

    cfg = ModelConfig(d_model=64, n_heads=4, d_ff=128, encoder_layers=2, decoder_layers=2,
                      vocos_dim=128, vocos_ff=256, vocos_layers=2)
    return resolve_device("cuda"), tts.TTS(cfg, torch.Generator().manual_seed(0)), np.random.default_rng(0)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("t,lengths,window", [(64, [64, 40], None), (128, [128, 77], 16), (48, [48, 31], 8)])
def test_transformer_stack_kernel_matches_plain(setup, bf16, t, lengths, window):
    dev, model, rng = setup
    dt = torch.bfloat16 if bf16 else torch.float32
    packed = {k: v.to(dev) for k, v in ts_op.pack_params(model.acoustic.encoder, dt).items()}
    mask = torch.as_tensor((np.arange(t)[None] < np.asarray(lengths)[:, None]).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.standard_normal((2, t, 64)).astype(np.float32), device=dev) * mask[..., None]
    before = ops.launch_counts()["transformer_stack"]
    ours = ts_op.transformer_stack(x, mask, packed, 4, window, bf16)
    plain = ts_op.transformer_stack_plain(x, mask, packed, 4, window, bf16)
    torch.cuda.synchronize()
    assert ops.launch_counts()["transformer_stack"] == before + 1
    assert ours.dtype == dt
    assert float((ours.float() - plain.float()).abs().max()) < (0.1 if bf16 else 2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,t", [(2, 50), (1, 122)])
def test_vocos_stack_kernel_matches_plain(setup, bf16, b, t):
    dev, model, rng = setup
    dt = torch.bfloat16 if bf16 else torch.float32
    packed = {k: v.to(dev) for k, v in vs_op.pack_params(model.vocoder.blocks, dt).items()}
    x = torch.as_tensor(rng.standard_normal((b, t, 128)).astype(np.float32), device=dev)
    ours = vs_op.vocos_stack(x, packed, bf16)
    plain = vs_op.vocos_stack_plain(x, packed, bf16)
    torch.cuda.synchronize()
    assert ours.dtype == dt
    assert float((ours.float() - plain.float()).abs().max()) < (0.1 if bf16 else 2e-3)


@pytest.mark.gpu
def test_wrapper_raises_on_inputs_the_kernel_does_not_take(setup):
    dev, model, _ = setup
    packed = {k: v.to(dev) for k, v in ts_op.pack_params(model.acoustic.encoder, torch.float32).items()}
    x = torch.zeros((1, 40, 64), device=dev)
    with pytest.raises(ValueError):  # T % window != 0 on the local path
        ts_op.transformer_stack(x, torch.ones((1, 40), device=dev), packed, 4, window=16)
    with pytest.raises(ValueError):  # weights packed for another compute dtype
        ts_op.transformer_stack(x, torch.ones((1, 40), device=dev), packed, 4, bf16=True)
