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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gonova_tts_tpu_torch import ops
from gonova_tts_tpu_torch.config import ModelConfig
from gonova_tts_tpu_torch.models import tts
from gonova_tts_tpu_torch.ops import convnext_block as cb_op
from gonova_tts_tpu_torch.ops import gemm_tc as gemm_op
from gonova_tts_tpu_torch.ops import mel_spectrogram as mel_op
from gonova_tts_tpu_torch.ops import snake_aa as snake_op
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


# ------------------------------------------------------------------ the bf16 tensor-core GEMM

# One bf16 ulp (2^-7 relative, about 0.8%) per rounding of the epilogue, plus 1e-2
# absolute: the kernel and the plain version sum K in another order, which can move a
# value across a bf16 rounding point. The bias and ReLU epilogues round once; the
# others twice (the term, then the result). The ulp is taken of |output|, or, for the
# two residual epilogues, of |output| + |resid|: the rounded term is at most that
# large, and the sum may cancel.
GEMM_RTOL, GEMM_ATOL = 2.0 ** -7, 1e-2
EPILOGUES = [gemm_op.EPI_BIAS, gemm_op.EPI_BIAS_RELU, gemm_op.EPI_RESID_MASK, gemm_op.EPI_GELU,
             gemm_op.EPI_GAMMA_RESID]


def gemm_inputs(dev, rng, b, t, cin, n, taps):
    bf = lambda x: torch.as_tensor(x.astype(np.float32), device=dev).bfloat16()  # noqa: E731
    k = taps * cin
    lengths = np.maximum(1, t - np.arange(b) * (t // 3))
    return dict(
        a=bf(rng.standard_normal((b, t, cin))), w=bf(rng.standard_normal((k, n)) / np.sqrt(k)),
        bias=torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev),
        resid=bf(rng.standard_normal((b, t, n))),
        mask=torch.as_tensor((np.arange(t)[None] < lengths[:, None]).astype(np.float32), device=dev),
        gamma=torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev),
    )


def run_gemm(fn, x, epi, taps):
    return fn(x["a"], x["w"], epi, x["bias"], x["resid"], x["mask"], x["gamma"], taps)


def assert_gemm_close(ours, plain, x, epi):
    scale = plain.float().abs()
    if epi in (gemm_op.EPI_RESID_MASK, gemm_op.EPI_GAMMA_RESID):
        scale = scale + x["resid"].float().abs()
    roundings = 1 if epi in (gemm_op.EPI_BIAS, gemm_op.EPI_BIAS_RELU) else 2
    err = (ours.float() - plain.float()).abs()
    assert bool((err <= GEMM_ATOL + roundings * GEMM_RTOL * scale).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 192, 256, 1536])
@pytest.mark.parametrize("t", [1, 50, 122, 320])
@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("taps", [1, 3])
def test_gemm_tc_matches_plain(setup, taps, epi, t, n):
    dev, _, rng = setup
    x = gemm_inputs(dev, rng, 2, t, 128, n, taps)
    before = ops.launch_counts()["gemm_tc"]
    ours = run_gemm(gemm_op.gemm_tc, x, epi, taps)
    plain = run_gemm(gemm_op.gemm_tc_plain, x, epi, taps)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gemm_tc"] == before + 1
    assert ours.dtype == torch.bfloat16 and ours.shape == plain.shape == (2, t, n)
    assert_gemm_close(ours, plain, x, epi)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,cin,n,taps,epi", [
    (4, 64, 1024, 256, 3, gemm_op.EPI_RESID_MASK),   # conv-FFN2: K = 3072 split in three
    (4, 320, 1024, 256, 3, gemm_op.EPI_RESID_MASK),
    (1, 122, 1536, 512, 1, gemm_op.EPI_GAMMA_RESID),  # Vocos w2
    (4, 320, 512, 1536, 1, gemm_op.EPI_GELU),         # Vocos w1
    (16, 512, 512, 1536, 1, gemm_op.EPI_GELU),        # 128 x 128 tiles
    (4, 512, 256, 1024, 3, gemm_op.EPI_BIAS_RELU),    # conv-FFN1
    (4, 512, 256, 768, 1, gemm_op.EPI_BIAS),          # QKV
])
def test_gemm_tc_serving_products(setup, b, t, cin, n, taps, epi):
    """The serving products at full width: against the plain version, and twice on
    the same input bit for bit."""
    dev, _, rng = setup
    x = gemm_inputs(dev, rng, b, t, cin, n, taps)
    ours = run_gemm(gemm_op.gemm_tc, x, epi, taps)
    again = run_gemm(gemm_op.gemm_tc, x, epi, taps)
    plain = run_gemm(gemm_op.gemm_tc_plain, x, epi, taps)
    torch.cuda.synchronize()
    assert torch.equal(ours, again)
    assert_gemm_close(ours, plain, x, epi)


@pytest.mark.gpu
@pytest.mark.parametrize("cin,n,taps,epi", [
    (512, 1536, 1, gemm_op.EPI_GELU), (1536, 512, 1, gemm_op.EPI_GAMMA_RESID),
    (256, 1024, 3, gemm_op.EPI_BIAS_RELU), (1024, 256, 3, gemm_op.EPI_RESID_MASK),
])
def test_gemm_tc_rows_do_not_depend_on_m(setup, cin, n, taps, epi):
    """C(A)[:m] == C(A[:m]) bit for bit, and the same bits from every tile: a row's
    sum depends on (N, K) alone. For the conv the prefix is of sequences (the batch);
    for plain rows also of the rows of one sequence."""
    dev, _, rng = setup
    x = gemm_inputs(dev, rng, 4, 320, cin, n, taps)
    whole = run_gemm(gemm_op.gemm_tc, x, epi, taps)
    split = gemm_op.split_k(n, taps * cin)
    for wgs, bn in gemm_op.TILES:
        forced = gemm_op.gemm_tc(x["a"], x["w"], epi, x["bias"], x["resid"], x["mask"], x["gamma"], taps,
                                 force_plan=(wgs, bn, split))
        assert torch.equal(forced, whole), (wgs, bn)
    first = {k: (v[:1] if k in ("a", "resid", "mask") else v) for k, v in x.items()}
    assert torch.equal(run_gemm(gemm_op.gemm_tc, first, epi, taps), whole[:1])
    if taps == 1:
        rows = {k: (v[:1, :122] if k in ("a", "resid", "mask") else v) for k, v in x.items()}
        assert torch.equal(run_gemm(gemm_op.gemm_tc, rows, epi, taps), whole[:1, :122])


@pytest.mark.gpu
def test_gemm_tc_raises_on_what_it_does_not_take(setup):
    dev, _, rng = setup
    x = gemm_inputs(dev, rng, 1, 16, 96, 128, 1)  # K per tap not a multiple of 64
    with pytest.raises(ValueError):
        run_gemm(gemm_op.gemm_tc, x, gemm_op.EPI_BIAS, 1)
    x = gemm_inputs(dev, rng, 1, 16, 64, 100, 1)  # N not a multiple of 8
    with pytest.raises(ValueError):
        run_gemm(gemm_op.gemm_tc, x, gemm_op.EPI_BIAS, 1)
    x = gemm_inputs(dev, rng, 1, 16, 64, 128, 1)
    with pytest.raises(ValueError):  # float32 operands: the tensor-core kernel is bf16 only
        gemm_op.gemm_tc(x["a"].float(), x["w"].float(), gemm_op.EPI_BIAS, x["bias"])


@pytest.mark.gpu
def test_transformer_stack_bf16_rows_do_not_depend_on_t(setup):
    """A prefix-masked batch at T = 320 and the same sequences padded to T = 448 (other
    tiles, other grids, more masked keys): the valid rows are bit-equal."""
    dev, model, rng = setup
    packed = {k: v.to(dev) for k, v in ts_op.pack_params(model.acoustic.decoder, torch.bfloat16).items()}
    # No sequence fills T = 320: the frame after a sequence's last is then a masked
    # frame at both lengths (at T = 320 a full sequence would meet the conv's zero edge).
    lengths = np.array([300, 250, 97, 1])
    x = torch.zeros((4, 448, 64), device=dev)
    x[:, :320] = torch.as_tensor(rng.standard_normal((4, 320, 64)).astype(np.float32), device=dev)
    mask = torch.as_tensor((np.arange(448)[None] < lengths[:, None]).astype(np.float32), device=dev)
    x = x * mask[..., None]
    short = ts_op.transformer_stack(x[:, :320].contiguous(), mask[:, :320].contiguous(), packed, 4, None, True)
    long = ts_op.transformer_stack(x, mask, packed, 4, None, True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(long.float()).all())
    for i, n in enumerate(lengths):
        assert torch.equal(short[i, :n], long[i, :n]), f"sequence {i}"


@pytest.mark.gpu
def test_bf16_stacks_raise_on_widths_the_tensor_core_gemm_does_not_take(setup):
    dev, _, _ = setup
    cfg = ModelConfig(d_model=96, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1,
                      vocos_dim=96, vocos_ff=256, vocos_layers=1)
    model = tts.TTS(cfg, torch.Generator().manual_seed(0))
    packed = {k: v.to(dev) for k, v in ts_op.pack_params(model.acoustic.encoder, torch.bfloat16).items()}
    with pytest.raises(ValueError, match="multiple of 64"):  # K per tap = d_model = 96
        ts_op.transformer_stack(torch.zeros((1, 32, 96), device=dev), torch.ones((1, 32), device=dev), packed, 2, bf16=True)
    packed = {k: v.to(dev) for k, v in vs_op.pack_params(model.vocoder.blocks, torch.bfloat16).items()}
    with pytest.raises(ValueError, match="multiple of 64"):
        vs_op.vocos_stack(torch.zeros((1, 32, 96), device=dev), packed, bf16=True)


# ------------------------------------------------------------------ the fourth slice's redesigns


@pytest.mark.gpu
@pytest.mark.parametrize("epi,out_dtype", [
    (gemm_op.EPI_GELU_F32, torch.bfloat16), (gemm_op.EPI_GAMMA_RESID, torch.float32),
    (gemm_op.EPI_BIAS, torch.float32), (gemm_op.EPI_GELU_F32, torch.float32),
])
@pytest.mark.parametrize("cin,n", [(512, 1536), (1536, 512), (128, 256)])
def test_gemm_tc_gelu_f32_and_f32_output(setup, epi, out_dtype, cin, n):
    """The single block's epilogues alone: against the plain version, and a row's bits
    the same at M = 1280 and at its first 122 rows."""
    dev, _, rng = setup
    x = gemm_inputs(dev, rng, 4, 320, cin, n, 1)
    x["resid"] = x["resid"].to(out_dtype)
    run = lambda fn, d: fn(d["a"], d["w"], epi, d["bias"], d["resid"], d["mask"], d["gamma"], 1,  # noqa: E731
                           out_dtype=out_dtype)
    before = ops.launch_counts()["gemm_tc"]
    ours, plain = run(gemm_op.gemm_tc, x), run(gemm_op.gemm_tc_plain, x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gemm_tc"] == before + 1
    assert ours.dtype == out_dtype and ours.shape == plain.shape == (4, 320, n)
    assert_gemm_close(ours, plain, x, epi)
    rows = {k: (v[:1, :122] if k in ("a", "resid", "mask") else v) for k, v in x.items()}
    assert torch.equal(run(gemm_op.gemm_tc, rows), ours[:1, :122])


@pytest.mark.gpu
@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("b,t", [(4, 320), (1, 300)])
def test_convnext_block_bf16_mlp_at_checkpoint_widths_takes_the_tensor_core_gemm(setup, x_bf16, b, t):
    dev, _, rng = setup
    c, f = 512, 1536
    t_ = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = (t_(rng.standard_normal((7, c)) * 0.3), t_(rng.standard_normal(c) * 0.1), t_(1 + 0.1 * rng.standard_normal(c)),
            t_(0.1 * rng.standard_normal(c)), t_(rng.standard_normal((c, f)) / np.sqrt(c)), t_(0.1 * rng.standard_normal(f)),
            t_(rng.standard_normal((f, c)) / np.sqrt(f)), t_(0.1 * rng.standard_normal(c)), t_(np.full(c, 0.5)))
    x = t_(rng.standard_normal((b, t, c)))
    x = x.bfloat16() if x_bf16 else x
    count = ops.launch_counts()["convnext_block"]
    ours = cb_op.convnext_block(x, *args, bf16=True)  # makes the [N, K] weight copies
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = cb_op.convnext_block(x, *args, bf16=True)
        torch.cuda.synchronize()
    plain = cb_op.convnext_block_plain(x, *args, bf16=True)
    assert ops.launch_counts()["convnext_block"] == count + 2
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 3 and "dwconv_ln_kernel" in kernels[0], kernels
    assert all("gemm_tc_kernel" in k for k in kernels[1:]), kernels  # both MLP products on the tensor cores
    assert ours.dtype == x.dtype and torch.equal(ours, again)
    assert float((ours.float() - plain.float()).abs().max()) < 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("c,f", [(96, 256), (128, 160)])
def test_convnext_block_bf16_mlp_raises_on_widths_not_a_multiple_of_64(setup, c, f):
    dev, _, rng = setup
    t_ = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev)  # noqa: E731
    args = (t_(7, c), t_(c), t_(c), t_(c), t_(c, f), t_(f), t_(f, c), t_(c), t_(c))
    x = t_(1, 40, c)
    with pytest.raises(ValueError, match="multiple of 64"):
        cb_op.convnext_block(x, *args, bf16=True)
    out = cb_op.convnext_block(x, *args, bf16=False)  # the f32 MLP stays on the CUDA cores
    torch.cuda.synchronize()
    torch.testing.assert_close(out, cb_op.convnext_block_plain(x, *args, bf16=False), atol=2e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,hop", [(1, 239872, 256), (2, 8192, 64)])
def test_mel_spectrogram_is_one_launch_with_repeatable_bits(setup, b, t, hop):
    dev, _, rng = setup
    x = torch.as_tensor(0.1 * rng.standard_normal((b, t)).astype(np.float32), device=dev)
    x[:, t // 2:] = 0.0
    first = mel_op.mel_spectrogram(x, hop_length=hop)  # builds and caches the bases
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        second = mel_op.mel_spectrogram(x, hop_length=hop)
        torch.cuda.synchronize()
    device_events = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(device_events) == 1 and "mel_kernel" in device_events[0], device_events
    assert torch.equal(first, second)
    plain = mel_op.mel_spectrogram_plain(x, hop_length=hop)
    assert bool(((second - plain).abs() <= 2e-4 + 1e-4 * plain.abs()).all())


# ------------------------------------------------------------------ the sixth slice: training


@pytest.mark.gpu
def test_train_step_on_the_card_launches_no_kernel_and_matches_the_cpu(setup):
    """Two f32 steps of make_train_step (warmup 1: the second moves the weights) on
    the card and on the CPU from one tree and one batch: the loss parts agree per
    step within rtol 1e-3, and no kernel wrapper launches (the step runs the plain
    layers under autograd: the kernels have no backward)."""
    import copy

    from gonova_tts_tpu_torch.train import step as tstep

    dev, model, _ = setup
    cfg = model.cfg
    batch = tstep.synthetic_batch(cfg, batch=2, tokens=8, device="cpu")
    runs = {}
    for where in ("cpu", "cuda"):
        state = tstep.init_state(copy.deepcopy(model).to(where), tstep.make_optimizer(lr=1e-3, warmup=1, decay_steps=10))
        step = tstep.make_train_step(cfg)
        before = ops.launch_counts()
        parts = []
        for _ in range(2):
            state, metrics = step(state, {k: v.to(where) for k, v in batch.items()})
            parts.append({k: float(v) for k, v in metrics.items()})
        assert ops.launch_counts() == before
        runs[where] = parts
    for cpu, card in zip(runs["cpu"], runs["cuda"]):
        for k in cpu:
            np.testing.assert_allclose(card[k], cpu[k], rtol=1e-3, err_msg=k)


# ------------------------------------------------------------------ the seventh slice: the adversarial phase


@pytest.mark.gpu
def test_gan_pair_on_the_card_launches_no_kernel_and_matches_the_cpu(setup):
    """Two d/g pairs of make_gan_steps (warmup 1: the second moves the weights) on
    the card and on the CPU from one seeded generator (HiFi-GAN, initial width 32,
    folded) and critics (disc_width 0.25), over a 40-frame batch whose GAN crop
    fires: d, adv, fm and mel agree per pair within rtol 1e-4, and no kernel
    wrapper launches."""
    import copy

    from gonova_tts_tpu_torch.models import layers, vocoder
    from gonova_tts_tpu_torch.train import step as tstep

    cfg = ModelConfig(vocoder_family="hifigan", upsample_initial_channel=32, disc_width=0.25)
    gen0 = layers.group(vocoder=vocoder.init(torch.Generator().manual_seed(0), cfg))
    disc0 = vocoder.discriminators_init(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2), 0.25)
    rng = np.random.default_rng(3)
    batch = {
        "mel": rng.normal(-4.0, 2.0, (2, 40, cfg.n_mels)).astype(np.float32),
        "audio": (0.1 * rng.standard_normal((2, 40 * cfg.hop_length))).astype(np.float32),
        "frame_mask": np.ones((2, 40), np.float32),
    }
    runs = {}
    for where in ("cpu", "cuda"):
        opt = tstep.make_optimizer(lr=2e-4, warmup=1, decay_steps=10)
        gen = tstep.init_state(copy.deepcopy(gen0).to(where), opt)
        disc = tstep.init_state(copy.deepcopy(disc0).to(where), opt)
        d_step, g_step = tstep.make_gan_steps(cfg)
        b = {k: torch.as_tensor(v, device=where) for k, v in batch.items()}
        before = ops.launch_counts()
        parts = []
        for _ in range(2):
            disc, d = d_step(disc, gen.params, b["mel"], b["audio"])
            gen, m = g_step(gen, disc.params, b["mel"], b["audio"], b["frame_mask"])
            parts.append({"d": float(d), **{k: float(v) for k, v in m.items()}})
        assert ops.launch_counts() == before
        runs[where] = parts
    for cpu, card in zip(runs["cpu"], runs["cuda"]):
        for k in cpu:
            np.testing.assert_allclose(card[k], cpu[k], rtol=1e-4, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["transformer_stack", "vocos_stack", "mel_spectrogram", "convnext_block", "gemm_tc"])
def test_kernels_launch_on_the_tensors_card(setup, kernel):
    """Each kernel on cuda:1 while cuda:0 is current (as a data-parallel replica
    runs) against its plain version there, bf16 where it has a tensor-core route:
    the launch goes to the tensors' card and the shared-memory opt-in is made for
    that card too. Skips below two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _, model, rng = setup
    dev = torch.device("cuda", 1)
    model = model.to(dev)
    torch.cuda.set_device(0)
    x = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)  # noqa: E731
    if kernel == "transformer_stack":
        packed = {k: v.to(dev) for k, v in ts_op.pack_params(model.acoustic.encoder, torch.bfloat16).items()}
        mask = torch.ones((2, 64), device=dev)
        args = (x(2, 64, 64), mask, packed, 4, None, True)
        ours, plain = ts_op.transformer_stack(*args), ts_op.transformer_stack_plain(*args)
        bound = 0.1
    elif kernel == "vocos_stack":
        packed = {k: v.to(dev) for k, v in vs_op.pack_params(model.vocoder.blocks, torch.bfloat16).items()}
        args = (x(2, 50, 128), packed, True)
        ours, plain = vs_op.vocos_stack(*args), vs_op.vocos_stack_plain(*args)
        bound = 0.1
    elif kernel == "mel_spectrogram":
        audio = 0.1 * x(1, 128 * 256)
        ours, plain = mel_op.mel_spectrogram(audio), mel_op.mel_spectrogram_plain(audio)
        assert bool(((ours - plain).abs() <= 2e-4 + 1e-4 * plain.abs()).all())
        bound = None
    elif kernel == "convnext_block":
        blk = model.vocoder.blocks[0]
        args = (x(2, 100, 128), blk["dw"], blk["dw_b"], blk["ln"]["g"], blk["ln"]["b"], blk["pw1"]["w"],
                blk["pw1"]["b"], blk["pw2"]["w"], blk["pw2"]["b"], blk["gamma"])
        ours, plain = cb_op.convnext_block(*args, bf16=True), cb_op.convnext_block_plain(*args, bf16=True)
        bound = 0.1
    else:
        a, w = x(1, 50, 128).bfloat16(), (0.05 * x(128, 256)).bfloat16()
        bias = x(256)
        ours = gemm_op.gemm_tc(a, w, gemm_op.EPI_BIAS, bias)
        plain = gemm_op.gemm_tc_plain(a, w, gemm_op.EPI_BIAS, bias)
        bound = 0.05
    torch.cuda.synchronize(dev)
    assert ours.device == dev and torch.cuda.current_device() == 0
    if bound is not None:
        assert float((ours.float() - plain.float()).abs().max()) < bound


def _divergences(ng, model, chars, ids, other):
    """(word index, first differing step, top-2 logit gap there) for each row where
    `ids` and `other` differ up to their first EOS; the logits are `model`'s for
    its own prefix `ids` (causal: one teacher-forced pass gives every step's)."""
    logits = ng.teacher_logits(model, chars, ids).float().cpu()
    out = []
    for i, (a, b) in enumerate(zip(ids.cpu().tolist(), other.cpu().tolist())):
        if ng.decode_ids(np.asarray(a)) == ng.decode_ids(np.asarray(b)):
            continue
        t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        top = torch.topk(logits[i, t], 2).values
        out.append((i, t, float(top[0] - top[1])))
    return out


@pytest.mark.gpu
def test_g2p_greedy_decode_on_the_card_matches_the_cpu(setup):
    """The vendored primary on the 1,255 held-out words: the card's greedy ids equal
    the CPU's, except where the top-2 logit gap at the first differing step is
    below 1e-3 (f32 summation order picks either side of a near-tie)."""
    from gonova_tts_tpu_torch.text import neural_g2p as ng
    from gonova_tts_tpu_torch.text.g2p import VENDORED_LEXICON
    from gonova_tts_tpu_torch.tools.g2p_eval import held_out_split

    dev = setup[0]
    tree = ng.load_weights()
    words = sorted(held_out_split(dict(VENDORED_LEXICON)))
    chars = torch.as_tensor(np.stack([ng.encode_word(w) for w in words])).long()
    cpu = ng.greedy_decode(ng.from_numpy_tree(tree, device="cpu"), chars)
    card_model = ng.from_numpy_tree(tree, device=dev)
    card = ng.greedy_decode(card_model, chars.to(dev))
    assert card.device.type == "cuda" and card.shape == (len(words), ng.MAX_PHONS)
    diverged = _divergences(ng, card_model, chars.to(dev), card, cpu)
    assert all(gap < 1e-3 for _, _, gap in diverged), diverged
    assert len(diverged) <= 5


@pytest.mark.gpu
def test_native_runtime_builds_and_loads(setup):
    from gonova_tts_tpu_torch.utils import native

    assert native.native_available(), native.native_error()
    pcm = np.arange(-4, 4, dtype=np.int16)
    np.testing.assert_array_equal(native.i16_to_f32(pcm), native.i16_to_f32_numpy(pcm))


@pytest.mark.gpu
def test_bench_tool_prints_a_positive_value(setup):
    """tools.bench at a small config on the card: the contract's four keys, a
    positive value, and a device reading beside each mode's wall time."""
    from gonova_tts_tpu_torch.config import EngineConfig
    from gonova_tts_tpu_torch.tools import bench

    cfg = ModelConfig(d_model=64, n_heads=4, d_ff=128, encoder_layers=2, decoder_layers=2, speaker_dim=32,
                      vocos_dim=128, vocos_ff=256, vocos_layers=2)
    detail, line = bench.run(cfg, EngineConfig(), "cuda", reps=1)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"} and line["value"] > 0
    assert detail["dtype"] == "bf16" and detail["device"] == torch.cuda.get_device_name(0)
    for mode in ("one_graph", "two_stage"):
        assert 0 < detail[f"{mode}_device_ms"] and 0 <= detail[f"{mode}_idle"] < 1


@pytest.mark.gpu
def test_bench_tstack_kernel_is_within_its_bound(setup):
    """tools.bench_tstack at a small shape, full and local attention: positive times,
    the kernel launched, its output within the bf16 bound of its plain twin. A device
    reading is positive, or None where every torch.profiler trace came back empty;
    never 0."""
    from gonova_tts_tpu_torch.tools import bench_tstack

    before = ops.launch_counts()["transformer_stack"]
    res = bench_tstack.run("cuda", d=64, heads=4, ff=128, n_layers=2,
                           cases=(("full", 2, 64, None), ("local", 2, 128, 16)), k=2, repeats=1)
    assert ops.launch_counts()["transformer_stack"] > before
    readings = [case[k] for case in res.values() for k in ("plain_device_ms", "fused_device_ms")]
    assert all(r is None or r > 0 for r in readings) and any(r is not None for r in readings)
    for case in res.values():
        assert case["plain_ms"] > 0 and case["fused_ms"] > 0
        assert case["max_abs_err"] < 0.1


# ---------------------------------------------------------------- CUDA graphs of the engine's pass

GRAPH_MODEL = dict(d_model=64, n_heads=4, d_ff=128, encoder_layers=2, decoder_layers=2, speaker_dim=32,
                   vocos_dim=128, vocos_ff=256, vocos_layers=2, upsample_initial_channel=64)
GRAPH_ENGINE = dict(token_buckets=[32, 64, 128], batch_buckets=[1, 4], max_batch=4,
                    warmup_shapes=[[1, 32], [4, 32], [4, 64]], vocode_frame_buckets=[128, 192, 256, 320],
                    stream_chunk_frames=24, stream_context_frames=12)
GRAPH_TEXTS = ["Hello there world.", "A second one here.", "Third one.", "Four words are here."]


def _graph_engines(model: dict, engine: dict):
    """(an engine whose warm-up captured its shapes, an eager engine on the same
    weights: its graph set taken away)."""
    from gonova_tts_tpu_torch.config import Config, EngineConfig
    from gonova_tts_tpu_torch.engine import TTSEngine

    def config():
        cfg = Config()
        cfg.model = ModelConfig(**{**GRAPH_MODEL, **model})
        cfg.engine = EngineConfig(**{**GRAPH_ENGINE, **engine})
        return cfg

    graphed = TTSEngine(config(), device="cuda")
    graphed.load()
    eager = TTSEngine(config(), device="cuda")
    eager.load(warmup=False)
    eager.params, eager.mcfg, eager._graphs = graphed.params, graphed.mcfg, None
    return graphed, eager


GRAPH_CASES = {
    "bigvgan": ({"vocoder_family": "bigvgan"}, {}),
    "vocos": ({}, {}),
    "vocos-kernels": ({"vocos_pallas": True}, {"acoustic_pallas": True}),
    "hifigan": ({"vocoder_family": "hifigan"}, {}),
    "hifigan-kernels": ({"vocoder_family": "hifigan"}, {"acoustic_pallas": True}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_passes_equal_the_eager_pass_at_every_warmed_shape(setup, case):
    """bf16, small widths. At every warmed (batch, token bucket) and each of its frame
    buckets the replayed encode, decode and vocoder give the eager pass's PCM16,
    sample for sample, and no part runs eagerly; served batches through
    `synthesize_batch` equal the eager engine's; `graphs_captured` is what `load()`
    left."""
    from gonova_tts_tpu_torch.models import graphs

    model, engine = GRAPH_CASES[case]
    graphed, eager = _graph_engines(model, engine)
    captured = graphed.get_stats()["graphs_captured"]
    assert captured == len(graphed._graphs) > 0
    rng = setup[2]
    with torch.inference_mode():
        for batch, bucket in graphed.ecfg.warmup_shapes:
            lengths = rng.integers(bucket // 2, bucket + 1, size=batch)
            tokens = np.where(np.arange(bucket)[None] < lengths[:, None],
                              rng.integers(1, 200, size=(batch, bucket)), 0).astype(np.int32)
            arrays = (tokens, (tokens > 0).astype(np.float32),
                      rng.standard_normal((batch, 32)).astype(np.float32), np.full((batch,), 0.4, np.float32))
            t_full = bucket * graphed.mcfg.max_frames_per_token
            for fb in graphed._frame_buckets(bucket):
                audio = []
                for eng in (graphed, eager):
                    args = eng._shards(*arrays)[0][1]
                    with graphs.active(eng._graphs) as gs:
                        e = tts.encode_acoustic(eng.params, *args, eng.mcfg, eng.compute_dtype)
                        out = tts.decode_vocode(eng.params, e["enc"], e["spk"], e["durations"], args[1], fb,
                                                eng.mcfg, eng.compute_dtype, local_attention_from=t_full)
                        audio.append(eng._pack(out["audio"]).cpu())
                    if gs is not None:
                        assert gs.eager == 0 and gs.replayed == 3, (batch, bucket, fb)
                assert torch.equal(audio[0], audio[1]), (case, batch, bucket, fb)
    for texts in (GRAPH_TEXTS, GRAPH_TEXTS[:1], GRAPH_TEXTS[1:3]):
        for g, w in zip(graphed.synthesize_batch(texts), eager.synthesize_batch(texts)):
            assert np.array_equal(g, w), case
    stats = graphed.get_stats()
    assert stats["graph_passes"] == 3 and stats["eager_passes"] == 0
    assert stats["graphs_captured"] == captured == len(graphed._graphs)


@pytest.mark.gpu
def test_an_unwarmed_shape_on_the_card_runs_eagerly(setup):
    graphed, eager = _graph_engines({}, {})
    captured = graphed.get_stats()["graphs_captured"]
    text = " ".join(["word"] * 30)  # past 64 tokens: bucket 128, not warmed
    got = graphed.synthesize_batch([text])[0]
    assert np.array_equal(got, eager.synthesize_batch([text])[0])
    stats = graphed.get_stats()
    assert stats["eager_passes"] == 1 and stats["graph_passes"] == 0
    assert stats["graphs_captured"] == captured == len(graphed._graphs)


@pytest.mark.gpu
def test_streaming_beside_graphs_matches_the_one_shot_pass(setup):
    """f32: streamed windows run eagerly and equal the replayed one-shot pass within
    the engine's streaming bound (2.5 / 32768)."""
    graphed, _ = _graph_engines({"compute_dtype": "float32"}, {})
    for text in GRAPH_TEXTS[:2]:
        streamed = np.concatenate(list(graphed.synthesize_stream(text)))
        one_shot = graphed.synthesize_batch([text])[0]
        assert streamed.shape == one_shot.shape
        assert float(np.abs(streamed - one_shot).max()) <= 2.5 / 32768
    assert graphed.get_stats()["graph_passes"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["vocos", "hifigan", "bigvgan"])
def test_the_profiler_sees_replayed_kernels_inside_the_vocoders_range(setup, monkeypatch, family):
    """A `record_function` range around the vocoder's `forward`, as the benchmark's
    probe opens one, holds the replayed graph's device time: within a factor of two
    of the eager pass's, with the pass on a worker thread and every thread profiled
    (as the benchmark's trace does)."""
    import threading

    from torch.profiler import record_function

    from gonova_tts_tpu_torch.models import tts as tts_mod

    graphed, eager = _graph_engines({"vocoder_family": family}, {})
    real = tts_mod._vocoder_forward(graphed.mcfg)
    mod = __import__(real.__module__, fromlist=["forward"])

    def ranged(params, mel, *args, **kw):
        with record_function(f"probe.vocoder:{mel.shape[0]}x{mel.shape[1]}"):
            return real(params, mel, *args, **kw)

    monkeypatch.setattr(mod, "forward", ranged)
    try:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        config = None
    device_us = {}
    for name, eng in (("graphed", graphed), ("eager", eager)):
        eng.synthesize_batch(GRAPH_TEXTS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], experimental_config=config) as prof:
            worker = threading.Thread(target=eng.synthesize_batch, args=(GRAPH_TEXTS,))
            worker.start()
            worker.join()
            torch.cuda.synchronize()
        ranges = [e for e in prof.events() if e.name.startswith("probe.vocoder:") and e.device_type == DeviceType.CPU]
        assert len(ranges) == 1, name
        device_us[name] = ranges[0].device_time_total
    assert graphed.get_stats()["graph_passes"] == 2
    assert 0.5 * device_us["eager"] < device_us["graphed"] < 2.0 * device_us["eager"], device_us


# ---------------------------------------------------------------- BigVGAN-v2's anti-aliased Snake-beta

# (channels, samples a mel frame) of each published stage of bigvgan_v2_24khz_100band_256x
SNAKE_STAGES = [(768, 4), (384, 16), (192, 32), (96, 64), (48, 128), (24, 256)]
BIGVGAN_NARROW = dict(vocoder_family="bigvgan", upsample_initial_channel=128, upsample_rates=[4, 4, 2, 2, 2, 2],
                      upsample_kernels=[8, 8, 4, 4, 4, 4], resblock_kernels=[3, 7, 11],
                      resblock_dilations=[[1, 3, 5]] * 3)


def _snake_inputs(b, t, c, dtype, seed, layout="channels_last"):
    """x [B, T, C] (contiguous, or lying as [B, C, T] with `layout="rows"`), the
    activation's constants and a conv bias."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, c, t) if layout == "rows" else (b, t, c), generator=g, device="cuda") * 2.0
    x = (x.transpose(1, 2) if layout == "rows" else x).to(dtype)
    log_a, log_b = (torch.randn(c, generator=g, device="cuda") * 0.3 for _ in range(2))
    return x, snake_op.constants(log_a, log_b), torch.randn(c, generator=g, device="cuda") * 0.3


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("c,per_frame", SNAKE_STAGES)
def test_snake_aa_kernel_matches_its_twin_at_the_published_stages(setup, b, c, per_frame):
    """bf16 in and out at 448 frames, x [B, T, C] contiguous (B = 16 with a conv bias
    added as it loads), the math in f32 on both sides (the kernel's sine the
    hardware's): where the two f32 results straddle a bf16 rounding point they differ
    by one bf16 step, so |kernel - twin| <= 2^-7 |twin| + 1e-4, and at least 99% of
    the samples are equal. One launch a call; the result [B, T, C] contiguous."""
    t = 448 * per_frame
    x, consts, bias = _snake_inputs(b, t, c, torch.bfloat16, b * 1000 + c)
    bias = bias if b == 16 else None
    before = ops.launch_counts().get("snake_aa", 0)
    ours = snake_op.snake_aa(x, *consts, bias)
    plain = snake_op.snake_aa_plain(x, *consts, bias)
    torch.cuda.synchronize()
    assert ops.launch_counts()["snake_aa"] == before + 1
    assert ours.dtype == torch.bfloat16 and ours.shape == x.shape and ours.is_contiguous()
    diff = (ours.float() - plain.float()).abs()
    assert bool((diff <= 2.0 ** -7 * plain.float().abs() + 1e-4).all())
    assert float((diff == 0).float().mean()) >= 0.99


# Lengths at both replicate pads (1, 2, 3, 5, 13), at each built segment length's edges
# (8, 16 and 32, ± 1), and past them: the first interior segment starts at T = 2 SEG + 5.
SNAKE_EDGE_LENGTHS = [1, 2, 3, 5, 7, 8, 9, 13, 15, 16, 17, 21, 31, 32, 33, 37, 69, 1300]


@pytest.mark.gpu
@pytest.mark.parametrize("t", SNAKE_EDGE_LENGTHS)
@pytest.mark.parametrize("c", [3, 24, 48])
@pytest.mark.parametrize("layout", ["rows", "channels_last"])
def test_snake_aa_kernel_edges_in_f32(setup, t, c, layout):
    """f32 at the lengths where both replicate pads reach every output, at the
    segment edges and at channel counts that take fewer channels a lane (3) or none
    past the plan's (24, 48); x lying [B, C, T] is copied to [B, T, C] first: within
    2e-6 of the output's scale (f32 summation order, the library sine)."""
    x, consts, bias = _snake_inputs(3, t, c, torch.float32, t * 10 + c, layout)
    for b in (None, bias):
        ours = snake_op.snake_aa(x, *consts, b)
        plain = snake_op.snake_aa_plain(x, *consts, b)
        torch.cuda.synchronize()
        assert ours.shape == x.shape and ours.dtype == torch.float32 and ours.is_contiguous()
        assert float((ours - plain).abs().max()) <= 2e-6 * max(1.0, float(plain.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("plan", snake_op.PLANS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_snake_aa_every_built_plan_matches_its_twin(setup, plan, dtype):
    """Every (channels a lane, outputs a lane) the kernel builds, at each edge length
    and 48 channels, with a bias: f32 within 2e-6 of the scale, bf16 within a bf16
    step (2^-7 |twin| + 1e-4)."""
    for t in SNAKE_EDGE_LENGTHS:
        x, consts, bias = _snake_inputs(2, t, 48, dtype, t)
        ours = snake_op._launch(x, *consts, bias, plan=plan).float()
        plain = snake_op.snake_aa_plain(x, *consts, bias).float()
        torch.cuda.synchronize()
        diff = (ours - plain).abs()
        if dtype == torch.float32:
            assert float(diff.max()) <= 2e-6 * max(1.0, float(plain.abs().max())), (plan, t)
        else:
            assert bool((diff <= 2.0 ** -7 * plain.abs() + 1e-4).all()), (plan, t)


@pytest.mark.gpu
def test_snake_aa_raises_on_what_the_kernel_does_not_take(setup):
    x, (alpha, inv_beta), bias = _snake_inputs(1, 64, 8, torch.float16, 0)
    with pytest.raises(ValueError):
        snake_op.snake_aa(x, alpha, inv_beta)
    x = x.float()
    with pytest.raises(ValueError):
        snake_op.snake_aa(x, alpha[:4], inv_beta[:4])
    with pytest.raises(ValueError):
        snake_op.snake_aa(x, alpha.double(), inv_beta)
    with pytest.raises(ValueError):
        snake_op.snake_aa(x, alpha, inv_beta, bias.bfloat16())


@pytest.mark.gpu
def test_bigvgan_forward_is_109_launches_eager_and_replayed(setup):
    """The published stage structure (rates 4,4,2,2,2,2, AMP blocks 3/7/11 x 1,3,5) at
    128 channels, bf16: an eager forward launches the kernel 109 times, and so does a
    replayed pass's vocoder graph (counted by `graphs.run`); the replayed batch equals
    the eager engine's sample for sample."""
    from gonova_tts_tpu_torch.models import bigvgan

    graphed, eager = _graph_engines(BIGVGAN_NARROW, {})
    assert bigvgan.activations(graphed.mcfg) == 109
    count = lambda: ops.launch_counts().get("snake_aa", 0)  # noqa: E731
    mel = torch.randn((2, 40, graphed.mcfg.n_mels), device="cuda")
    before = count()
    with torch.inference_mode():
        wav = bigvgan.forward(graphed.params.vocoder, mel, graphed.mcfg, torch.bfloat16)
    torch.cuda.synchronize()
    assert count() - before == 109 and wav.shape == (2, 40 * 256)
    before = count()
    got = graphed.synthesize_batch(GRAPH_TEXTS)
    assert count() - before == 109
    assert graphed.get_stats()["graph_passes"] == 1
    before = count()
    want = eager.synthesize_batch(GRAPH_TEXTS)
    assert count() - before == 109
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.gpu
def test_a_replayed_bigvgan_forward_runs_channels_last_end_to_end(setup):
    """The published generator (1536 channels, 100 mels), B=4 and 64 frames, bf16,
    one forward replayed from a CUDA graph under the profiler: no cuDNN layout conversion
    (`nchwToNhwc`, `nhwcToNchw`) runs, a kernel named `snake_aa_kernel` runs 109
    times, and the replay counts 116 channels-last convs (`conv_nwc`). An eager
    forward after the packing casts nothing but the mel in and the waveform out."""
    from gonova_tts_tpu_torch.models import bigvgan, graphs

    cfg = ModelConfig(**{**BIGVGAN_NARROW, "upsample_initial_channel": 1536, "n_mels": 100})
    gen = bigvgan.init(torch.Generator().manual_seed(0), cfg).to("cuda")
    mel = torch.randn((4, 64, cfg.n_mels), device="cuda")
    gs = graphs.GraphSet(torch.device("cuda"))
    with torch.inference_mode():
        with gs.side_stream():
            bigvgan.forward(gen, mel, cfg, torch.bfloat16)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as eager:
            bigvgan.forward(gen, mel, cfg, torch.bfloat16)
        with graphs.active(gs, capture=True):
            bigvgan.forward(gen, mel, cfg, torch.bfloat16)
        with graphs.active(gs):
            want = bigvgan.forward(gen, mel, cfg, torch.bfloat16).clone()
        before = ops.launch_counts().get("conv_nwc", 0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with graphs.active(gs) as active:
                got = bigvgan.forward(gen, mel, cfg, torch.bfloat16)
            torch.cuda.synchronize()
    assert active.replayed == 1 and active.eager == 0
    assert ops.launch_counts()["conv_nwc"] - before == bigvgan.convs(cfg) == 116
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert not [k for k in kernels if "nchwToNhwc" in k or "nhwcToNchw" in k]
    assert sum("snake_aa_kernel" in k for k in kernels) == 109
    assert torch.equal(got, want)
    copies = [e.name for e in eager.events() if e.name in ("aten::_to_copy", "aten::clone")]
    assert copies.count("aten::_to_copy") == 2 and "aten::clone" not in copies, copies


# ---------------------------------------------------------------- F5-TTS v1 at published widths

# One DiT evaluation in bf16 against the float32 reference (TF32 off): bf16 products
# and activations through 22 blocks move the guided velocity (|v| ~3 on average at
# the seeded weights) by ~1e-2 on average, ~0.2 at most.
F5_VELOCITY_MEAN = 0.05
F5_VELOCITY_MAX = 1.0


@pytest.fixture(scope="module")
def f5_engine(setup, tmp_path_factory):
    """An engine serving the published F5TTS_v1_Base widths from seeded weights (the
    benchmark's generator), graphs captured at (2, 1536), and prompts of three of the
    benchmark's recordings."""
    from gonova_tts_tpu_torch.config import Config, EngineConfig
    from gonova_tts_tpu_torch.engine import TTSEngine
    from tts_bench import prompts
    from tts_bench.reference import audio as ref_audio
    from tts_bench.voices import Voice
    from tts_bench.weights import f5 as weights

    cfg = Config()
    cfg.model = ModelConfig(acoustic_family="f5", n_mels=100, vocos_head="polar", device="cuda")
    cfg.engine = EngineConfig(f5_frame_buckets=[1536, 4096], batch_buckets=[1, 2, 4], warmup_shapes=[[2, 1536]])
    path = str(tmp_path_factory.mktemp("f5") / "f5.npz")
    np.savez(path, **weights.make(cfg.model.model_dump(), 7, "cuda"))
    cfg.model.model_path = path
    eng = TTSEngine(cfg)
    eng.load()
    voices = [Voice(7, i, sr) for i, sr in enumerate([24000, 44100])]
    ps = [eng.make_prompt(*ref_audio.read_wav(v.wav), prompts.transcript(v.wav)) for v in voices]
    return eng, ps, path


F5_SENTENCES = ["The harbor was quiet when the boats came home.", "She opened the letter, and read it twice.",
                "Nobody expected the rain to stop so soon!", "A short one."]


@pytest.mark.gpu
def test_f5_one_evaluation_matches_the_reference_at_published_widths(f5_engine):
    """B = 4, L = 1,536: the port's bf16 DiT (conditioning, time embedding, 22
    blocks, guidance) against reference/f5.py's f32 DiT, each row alone at its L."""
    from gonova_tts_tpu_torch.models import f5
    from tts_bench.reference import f5 as reference
    from tts_bench.reference.model import load_tree

    eng, ps, path = f5_engine
    rows = [eng.plan(s, ps[i % 2]).row for i, s in enumerate(F5_SENTENCES)]
    assert max(r.frames for r in rows) <= 1536
    ids1, cond, x0, lens, _, _, _ = (torch.as_tensor(a, device="cuda") for a in eng._f5_arrays(rows, 4, 1536))
    t = torch.tensor([0.3], device="cuda")
    with torch.inference_mode():
        fixed = f5.condition(eng.params["acoustic"], ids1, cond, lens, eng.mcfg, torch.bfloat16)
        got = f5.velocity(eng.params["acoustic"], x0, fixed, lens, t, eng.mcfg, torch.bfloat16)
        tree, _ = load_tree(path, "cuda")
        ref = reference.Reference(tree, eng.mcfg.model_dump(), "cuda")
        for i, r in enumerate(rows):
            text = ref.dit.text(torch.as_tensor(r.ids, device="cuda"), r.frames)
            want = ref.dit.velocity(x0[i, : r.frames], cond[i, : r.frames], text, t)
            err = (got[i, : r.frames] - want).abs()
            assert float(want.abs().mean()) > 0.5  # the adaLN gates and proj_out are drawn, not zero
            assert float(err.mean()) < F5_VELOCITY_MEAN and float(err.max()) < F5_VELOCITY_MAX, i


@pytest.mark.gpu
def test_f5_a_captured_pass_replays_the_eager_audio(f5_engine):
    eng, ps, _ = f5_engine
    assert eng.get_stats()["graphs_captured"] == 4  # conditioning, step, gather, vocoder
    texts = F5_SENTENCES[:2]
    before = eng.get_stats()["graph_passes"]
    got = eng.synthesize_batch(texts, ps)
    graphs_ = eng._graphs
    eng._graphs = None
    try:
        want = eng.synthesize_batch(texts, ps)
    finally:
        eng._graphs = graphs_
    assert eng.get_stats()["graph_passes"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
        assert float(np.sqrt(np.mean(g ** 2))) > 0.01
