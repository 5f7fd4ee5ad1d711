"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Needs a CUDA device and nvcc, and no JAX (the machine with the card has none), so
run it without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Elsewhere every case skips. Tolerances: f32 2e-3 (summation order through a
4-layer stack), bf16 0.1 (a one-ulp difference at a bf16 rounding point, about
0.4%, carried through the later layers); the log-mel 2e-4 + 1e-4 * |ref| (the JAX
kernel test's bound: f32 summation order under a log); one ConvNeXt block in f32
2e-4.
"""

import numpy as np
import pytest
import torch

from gonova_tts_tpu_torch import ops
from gonova_tts_tpu_torch.config import ModelConfig
from gonova_tts_tpu_torch.models import tts
from gonova_tts_tpu_torch.ops import convnext_block as cb_op
from gonova_tts_tpu_torch.ops import mel_spectrogram as mel_op
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
@pytest.mark.parametrize("b,frames,hop", [(2, 2, 256), (1, 127, 256), (1, 128, 256), (3, 129, 256), (2, 40, 64)])
def test_mel_spectrogram_kernel_matches_plain(setup, b, frames, hop):
    dev, _, rng = setup
    t = max(frames * hop, 512)  # the reflect pad needs T > (n_fft - hop) // 2
    x = torch.as_tensor(0.1 * rng.standard_normal((b, t)).astype(np.float32), device=dev)
    x[:, t // 2:] = 0.0  # a silent tail: both floors
    before = ops.launch_counts()["mel_spectrogram"]
    ours = mel_op.mel_spectrogram(x, hop_length=hop)
    plain = mel_op.mel_spectrogram_plain(x, hop_length=hop)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mel_spectrogram"] == before + 1
    assert ours.shape == plain.shape == (b, t // hop, 80)
    assert bool(((ours - plain).abs() <= 2e-4 + 1e-4 * plain.abs()).all())
    one = mel_op.mel_spectrogram(x[0], hop_length=hop)  # [T] in, [frames, n_mels] out
    assert torch.equal(one, ours[0])


@pytest.mark.gpu
@pytest.mark.parametrize("x_bf16,bf16", [(False, False), (False, True), (True, True), (True, False)])
@pytest.mark.parametrize("b,t", [(2, 100), (1, 300)])
def test_convnext_block_kernel_matches_plain(setup, x_bf16, bf16, b, t):
    dev, model, rng = setup
    blk = model.vocoder.blocks[0].to(dev)
    args = (blk["dw"], blk["dw_b"], blk["ln"]["g"], blk["ln"]["b"], blk["pw1"]["w"], blk["pw1"]["b"],
            blk["pw2"]["w"], blk["pw2"]["b"], blk["gamma"])
    x = torch.as_tensor(rng.standard_normal((b, t, 128)).astype(np.float32), device=dev)
    x = x.bfloat16() if x_bf16 else x
    before = ops.launch_counts()["convnext_block"]
    ours = cb_op.convnext_block(x, *args, bf16=bf16)
    plain = cb_op.convnext_block_plain(x, *args, bf16=bf16)
    torch.cuda.synchronize()
    assert ops.launch_counts()["convnext_block"] == before + 1
    assert ours.dtype == x.dtype and ours.shape == x.shape
    assert float((ours.float() - plain.float()).abs().max()) < (0.1 if (bf16 or x_bf16) else 2e-4)


@pytest.mark.gpu
def test_embed_voice_on_the_card_takes_the_mel_kernel(setup):
    """A CUDA engine's embed_voice launches the fused mel once per call and agrees
    with the unfused mel (engine.mel_pallas off) within 1e-3; the card's resampler
    agrees with the CPU's within 1e-4."""
    from gonova_tts_tpu_torch.audio import resample
    from gonova_tts_tpu_torch.config import Config, EngineConfig
    from gonova_tts_tpu_torch.engine import TTSEngine

    dev, _, rng = setup
    cfg = Config()
    cfg.model = ModelConfig(d_model=64, n_heads=4, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
                            vocos_dim=128, vocos_ff=256, vocos_layers=2, compute_dtype="float32")
    cfg.engine = EngineConfig(warmup_shapes=[[1, 32]])
    eng = TTSEngine(cfg)
    eng.load(warmup=False)
    audio = (0.2 * rng.standard_normal(44100 * 2)).astype(np.float32)
    before = ops.launch_counts()["mel_spectrogram"]
    fused = eng.embed_voice(audio, 44100)
    assert ops.launch_counts()["mel_spectrogram"] == before + 1
    eng.ecfg.mel_pallas = False
    unfused = eng.embed_voice(audio, 44100)
    assert ops.launch_counts()["mel_spectrogram"] == before + 1
    assert fused.shape == (32,) and abs(float(np.linalg.norm(fused)) - 1.0) < 1e-4
    assert float(np.abs(fused - unfused).max()) < 1e-3
    on_card = resample(torch.as_tensor(audio, device=dev), 44100, 24000).cpu()
    assert float((on_card - resample(torch.as_tensor(audio), 44100, 24000)).abs().max()) < 1e-4


@pytest.mark.gpu
def test_new_wrappers_raise_on_inputs_the_kernels_do_not_take(setup):
    dev, model, _ = setup
    with pytest.raises(ValueError):  # hop does not divide n_fft
        mel_op.mel_spectrogram(torch.zeros((1, 3000), device=dev), hop_length=300)
    blk = model.vocoder.blocks[0].to(dev)
    args = (blk["dw"][:5], blk["dw_b"], blk["ln"]["g"], blk["ln"]["b"], blk["pw1"]["w"], blk["pw1"]["b"],
            blk["pw2"]["w"], blk["pw2"]["b"], blk["gamma"])
    with pytest.raises(ValueError):  # a 5-tap depthwise kernel
        cb_op.convnext_block(torch.zeros((1, 20, 128), device=dev), *args)


@pytest.mark.gpu
def test_wrapper_raises_on_inputs_the_kernel_does_not_take(setup):
    dev, model, _ = setup
    packed = {k: v.to(dev) for k, v in ts_op.pack_params(model.acoustic.encoder, torch.float32).items()}
    x = torch.zeros((1, 40, 64), device=dev)
    with pytest.raises(ValueError):  # T % window != 0 on the local path
        ts_op.transformer_stack(x, torch.ones((1, 40), device=dev), packed, 4, window=16)
    with pytest.raises(ValueError):  # weights packed for another compute dtype
        ts_op.transformer_stack(x, torch.ones((1, 40), device=dev), packed, 4, bf16=True)
