"""The port's DSP modules and its two audio-path kernel wrappers vs the JAX package.

Same numpy-seeded inputs through the JAX function and its counterpart in the port,
on the CPU. The Pallas kernels run in interpret mode (bf16=False for the f32
comparisons), as tests/test_kernels.py runs them; the port's wrappers, given CPU
tensors, run their plain versions. Tolerances: spectra and log-mels atol 2e-4 /
rtol 1e-4 (the JAX kernel test's bound: f32 summation order, under a log); the
resampler atol 1e-5 (polyphase summation order); one ConvNeXt block atol 2e-4 /
rtol 1e-4 in f32 and 0.1 in bf16 (a one-ulp bf16 flip at a rounding point).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.audio import mel as jmel
from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.models import vocos as jvocos
from gonova_tts_tpu.ops.convnext_kernel import convnext_block_pallas
from gonova_tts_tpu.ops.mel_kernel import mel_spectrogram_pallas
from gonova_tts_tpu_torch import ops
from gonova_tts_tpu_torch.audio import mel as tmel
from gonova_tts_tpu_torch.audio import stft as tstft
from gonova_tts_tpu_torch.ops import convnext_block as cb_op
from gonova_tts_tpu_torch.ops import gemm_tc as gemm_op
from gonova_tts_tpu_torch.ops import mel_spectrogram as mel_op

# Both `audio` packages export functions named like their modules (`stft`, `resample`).
jstft = importlib.import_module("gonova_tts_tpu.audio.stft")
jresample_mod = importlib.import_module("gonova_tts_tpu.audio.resample")
tresample_mod = importlib.import_module("gonova_tts_tpu_torch.audio.resample")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores: torch's own thread pool (8 spinning
    threads per worker) would starve the other workers' tests."""
    torch.set_num_threads(1)


ATOL, RTOL = 2e-4, 1e-4


def close(ours, theirs, atol=ATOL, rtol=RTOL):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=atol, rtol=rtol)


# ------------------------------------------------------------------ bases


@pytest.mark.parametrize("n_fft", [256, 1024])
def test_dft_and_idft_bases_equal(n_fft):
    for ours, theirs in zip(tstft.dft_bases(n_fft) + tstft.idft_bases(n_fft),
                            jstft.dft_bases(n_fft) + jstft.idft_bases(n_fft)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tstft.hann_window(n_fft), jstft.hann_window(n_fft))
    np.testing.assert_array_equal(tstft._full_window(n_fft, n_fft // 2), np.asarray(jstft._full_window(n_fft, n_fft // 2)))


@pytest.mark.parametrize("kw", [{}, {"sr": 16000, "n_fft": 512, "n_mels": 40, "fmax": None}, {"htk": True}])
def test_mel_filterbank_equal(kw):
    ours, theirs = tmel.mel_filterbank(**kw), jmel.mel_filterbank(**kw)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    f = np.array([0.0, 440.0, 1000.0, 8000.0])
    for htk in (False, True):
        np.testing.assert_array_equal(tmel.hz_to_mel(f, htk), jmel.hz_to_mel(f, htk))
        np.testing.assert_array_equal(tmel.mel_to_hz(f / 100, htk), jmel.mel_to_hz(f / 100, htk))


# ------------------------------------------------------------------ stft / mel


@pytest.mark.parametrize("t", [2048, 1000, 100])  # hop-aligned, ragged, shorter than the reflect pad
def test_frame_signal_equal(rng, t):
    x = rng.standard_normal((2, t)).astype(np.float32)
    ours = tstft.frame_signal(torch.as_tensor(x), 1024, 256).numpy()
    theirs = np.asarray(jstft.frame_signal(jnp.asarray(x), 1024, 256))
    np.testing.assert_array_equal(ours, theirs)


def test_frame_signal_when_hop_does_not_divide_n_fft(rng):
    x = rng.standard_normal((3000,)).astype(np.float32)
    ours = tstft.frame_signal(torch.as_tensor(x), 1024, 300).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jstft.frame_signal(jnp.asarray(x), 1024, 300)))


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (512, 128, 400)])
def test_stft_ri_and_spectrogram_match(rng, n_fft, hop, win):
    x = 0.3 * rng.standard_normal((2, hop * 12)).astype(np.float32)
    for ours, theirs in zip(tstft.stft_ri(torch.as_tensor(x), n_fft, hop, win),
                            jstft.stft_ri(jnp.asarray(x), n_fft, hop, win)):
        close(ours, theirs)
    for power in (1.0, 2.0, 0.5):
        close(tstft.spectrogram(torch.as_tensor(x), n_fft, hop, win, power=power),
              jstft.spectrogram(jnp.asarray(x), n_fft, hop, win, power=power))


@pytest.mark.parametrize("log", [True, False])
def test_mel_spectrogram_matches(rng, log):
    x = 0.1 * rng.standard_normal((2, 256 * 20)).astype(np.float32)
    x[1, 256 * 9:] = 0.0  # a silent tail: the 1e-9 and 1e-5 floors
    close(tmel.mel_spectrogram(torch.as_tensor(x), log=log), jmel.mel_spectrogram(jnp.asarray(x), log=log))


def test_mel_mse_and_mcd_match(rng):
    a = rng.standard_normal((2, 30, 80)).astype(np.float32)
    b = rng.standard_normal((2, 30, 80)).astype(np.float32)
    close(tmel.mel_mse(torch.as_tensor(a), torch.as_tensor(b)), jmel.mel_mse(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    close(tmel.mcd(torch.as_tensor(a), torch.as_tensor(b)), jmel.mcd(jnp.asarray(a), jnp.asarray(b)), 1e-4)
    assert float(tmel.mcd(torch.as_tensor(a), torch.as_tensor(a))) == 0.0


# ------------------------------------------------------------------ the mel kernel's wrapper


@pytest.mark.parametrize("frames", [2, 16, 127, 128, 129])
def test_mel_spectrogram_plain_matches_pallas(rng, frames):
    t = max(frames * 256, 512)  # the reflect pad needs T > 384
    x = 0.1 * rng.standard_normal((2, t)).astype(np.float32)
    x[1, t // 2:] = 0.0
    before = ops.launch_counts()["mel_spectrogram"]
    ours = mel_op.mel_spectrogram(torch.as_tensor(x))
    theirs = mel_spectrogram_pallas(jnp.asarray(x), interpret=True)
    assert ops.launch_counts()["mel_spectrogram"] == before  # CPU tensors: the plain version, no launch
    close(ours, theirs)
    close(ours, tmel.mel_spectrogram(torch.as_tensor(x)))  # and the unfused mel


def test_mel_spectrogram_plain_hop_64_framing(rng):
    """n_fft / hop = 16: the Pallas kernel hands this framing to the unfused JAX mel;
    the port's wrapper computes it itself."""
    x = 0.1 * rng.standard_normal((2, 64 * 40)).astype(np.float32)
    ours = mel_op.mel_spectrogram(torch.as_tensor(x), hop_length=64)
    assert ours.shape == (2, 40, 80)
    close(ours, mel_spectrogram_pallas(jnp.asarray(x), hop_length=64, interpret=True))


def test_mel_spectrogram_wrapper_shapes_and_errors(rng):
    x = 0.1 * rng.standard_normal((256 * 8 + 100,)).astype(np.float32)
    one = mel_op.mel_spectrogram(torch.as_tensor(x), n_mels=40, win_length=512)
    assert one.shape == (8, 40) and one.dtype == torch.float32  # [T] in; n_frames = T // hop
    theirs = mel_spectrogram_pallas(jnp.asarray(x), n_mels=40, win_length=512, interpret=True)
    close(one, theirs)
    with pytest.raises(ValueError):
        mel_op.mel_spectrogram(torch.as_tensor(x), hop_length=300)
    with pytest.raises(ValueError):
        mel_op.mel_spectrogram(torch.zeros((1, 2, 2048)))


def test_mel_spectrogram_casts_its_input_to_f32(rng):
    """Audio of another float dtype is cast to f32 first: the same bits as f32 audio."""
    x = 0.1 * rng.standard_normal((2, 4096))
    ours = mel_op.mel_spectrogram(torch.as_tensor(x))  # float64
    assert ours.dtype == torch.float32
    assert torch.equal(ours, mel_op.mel_spectrogram(torch.as_tensor(x.astype(np.float32))))


# ------------------------------------------------------------------ the mel kernel's arithmetic
#
# The kernel runs only on a card; these hold what it computes, in PyTorch on the CPU:
# its split-TF32 products, its basis layout, its reflect index and its banded mel.


def test_split_tf32_rounds_to_nearest_ties_away_and_keeps_f32_accuracy(rng):
    w = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-6, 3, 4096),
                        np.float32([0.0, -0.0, 1.0, -2.5])])
    # Exact ties: the low 13 bits 0x1000 round the magnitude up, whatever the sign.
    ties = (np.float32([1.0, -3.0, 0.7]).view(np.uint32) & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    w = np.concatenate([w, ties.view(np.float32)])
    hi, lo = mel_op.split_tf32(w)
    for v in (hi, lo):
        assert not (v.view(np.uint32) & np.uint32(0x1FFF)).any()  # 10 mantissa bits
    # Nearest: |w - hi| at most half a TF32 ulp of hi (2^-11 relative), with ties away.
    assert np.all(np.abs(w.astype(np.float64) - hi) <= 2.0 ** -11 * np.abs(hi) * (1 + 2.0 ** -10))
    tie_hi = hi[-3:]
    assert np.all(np.abs(tie_hi) > np.abs(ties.view(np.float32)))
    assert np.all(np.abs(w.astype(np.float64) - (hi.astype(np.float64) + lo)) <= 2.0 ** -21 * np.abs(w))


def unpack_tf32_bases(n_fft, win_length=1024):
    """(hi, lo), each [2 (cos, sin), n_fft, CLUSTER * BINS_PER_BLOCK], read back from the
    kernel's stage images with its own index arithmetic: bin j of block q, k = 32 kt +
    4 c + e at [q][kt][part][hi|lo][j][c ^ (j % 8)][e]."""
    g_, nb = mel_op.CLUSTER, mel_op.BINS_PER_BLOCK
    packed = mel_op.tf32_bases(n_fft, win_length, "cpu").numpy()
    packed = packed.reshape(g_, n_fft // 32, 2, 2, nb, 8, 4)
    swz = (np.arange(8)[None, :] ^ (np.arange(nb)[:, None] % 8)).reshape(1, 1, 1, 1, nb, 8, 1)
    logical = np.take_along_axis(packed, swz, axis=5)  # [q, kt, part, hi|lo, j, c, e]
    back = logical.transpose(3, 2, 1, 5, 6, 0, 4).reshape(2, 2, n_fft, g_ * nb)
    return back[0], back[1]


def mel_kernel_emulated(x, hop=256, n_fft=1024, n_mels=80):
    """The kernel's function in PyTorch: frames gathered through the reflect index,
    A split in two TF32 parts, re/im = A_lo B_hi + A_hi B_lo + A_hi B_hi in f32, mag,
    then each cluster rank's banded partial mel added in rank order, log."""
    b, t = x.shape
    n_frames, n_bins = t // hop, n_fft // 2 + 1
    src = mel_op.reflect_source(np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None], t, n_fft, hop)
    frames = np.where(src >= 0, x[:, np.maximum(src, 0)], 0.0).astype(np.float32)
    a_hi, a_lo = (torch.as_tensor(v) for v in mel_op.split_tf32(frames))
    b_hi, b_lo = (torch.as_tensor(v) for v in unpack_tf32_bases(n_fft))
    re, im = (a_lo @ b_hi[i] + a_hi @ b_lo[i] + a_hi @ b_hi[i] for i in (0, 1))
    mag = torch.sqrt(torch.clamp(re * re + im * im, min=1e-9))[..., :n_bins]
    fb = mel_op._filterbank_np(24000, n_fft, n_mels, 0.0, 12000.0)
    mel = banded_mel(mag, fb, mel_op.band_ranges(fb), mel_op.BINS_PER_BLOCK)
    return torch.log(torch.clamp(mel, min=1e-5))


def banded_mel(mag, fb, band, nb):
    """mag [..., n_bins] @ fb as the kernel sums it: per block of nb bins only the bins
    inside each band's range, the blocks' partials added in order."""
    n_bins, n_mels = fb.shape
    inside = (np.arange(n_bins)[:, None] >= band[0]) & (np.arange(n_bins)[:, None] < band[1])
    fb_banded = torch.as_tensor(np.where(inside, fb, 0.0).astype(np.float32))
    total = torch.zeros(mag.shape[:-1] + (n_mels,))
    for q0 in range(0, mel_op.CLUSTER * nb, nb):
        total = total + mag[..., q0:q0 + nb] @ fb_banded[q0:q0 + nb]
    return total


@pytest.mark.parametrize("frames,hop", [(129, 256), (40, 64), (2, 256)])
def test_split_tf32_mel_holds_the_kernel_tolerance(rng, frames, hop):
    """Three TF32 products instead of one f32 product: within the kernel's bound of the
    plain version and of the Pallas kernel, on audio with a silent tail."""
    t = max(frames * hop, 512)
    x = 0.1 * rng.standard_normal((2, t)).astype(np.float32)
    x[:, t // 2:] = 0.0
    ours = mel_kernel_emulated(x, hop)
    close(ours, mel_op.mel_spectrogram_plain(torch.as_tensor(x), hop_length=hop))
    close(ours, mel_spectrogram_pallas(jnp.asarray(x), hop_length=hop, interpret=True))


def test_tf32_bases_hold_the_split_folded_bases_in_fragment_order():
    n_fft = 1024
    hi, lo = unpack_tf32_bases(n_fft)
    wcos, wsin = (v.numpy() for v in mel_op.folded_bases(n_fft, 1024, "cpu"))
    for part, w in enumerate((wcos, wsin)):
        padded = np.zeros_like(hi[part])
        padded[:, : w.shape[1]] = w
        want_hi, want_lo = mel_op.split_tf32(padded)
        np.testing.assert_array_equal(hi[part], want_hi)
        np.testing.assert_array_equal(lo[part], want_lo)
    assert hi.shape[-1] == mel_op.CLUSTER * mel_op.BINS_PER_BLOCK == 576


@pytest.mark.parametrize("t", [1, 100, 384, 385, 386, 600, 1000, 4096])
@pytest.mark.parametrize("hop", [256, 64])
def test_reflect_source_gathers_the_reflect_pad(rng, t, hop):
    """The kernel's source index reproduces `reflect_pad`, short clips (T <= pad,
    zero-extended to pad + 1 first) included."""
    x = rng.standard_normal(t).astype(np.float32)
    padded = tstft.reflect_pad(torch.as_tensor(x), 1024, hop).numpy()
    src = mel_op.reflect_source(np.arange(padded.shape[-1]), t, 1024, hop)
    np.testing.assert_array_equal(np.where(src >= 0, x[np.maximum(src, 0)], 0.0), padded)


@pytest.mark.parametrize("kw", [{}, {"n_mels": 40, "fmax": None}, {"n_fft": 512, "n_mels": 64}])
def test_band_ranges_cover_every_nonzero_and_the_banded_mel_is_the_dense_one(rng, kw):
    n_fft, n_mels, fmax = kw.get("n_fft", 1024), kw.get("n_mels", 80), kw.get("fmax", 12000.0)
    fb = mel_op._filterbank_np(24000, n_fft, n_mels, 0.0, fmax)
    band = mel_op.band_ranges(fb)
    rows = np.arange(fb.shape[0])[:, None]
    assert not (fb[(rows < band[0]) | (rows >= band[1])] != 0).any()
    assert np.all(band[0] <= band[1]) and np.all(band[1] <= fb.shape[0])
    mag = torch.as_tensor(np.abs(rng.standard_normal((3, 7, fb.shape[0]))).astype(np.float32))
    dense = mag @ torch.as_tensor(fb)
    nb = mel_op.BINS_PER_BLOCK
    assert float((banded_mel(mag, fb, band, nb) - dense).abs().max()) <= 1e-6 * float(dense.abs().max())


# ------------------------------------------------------------------ resample


@pytest.mark.parametrize("sr,n", [(48000, 4801), (44100, 2205), (8000, 801), (16000, 1601), (22050, 1103)])
def test_resample_matches(rng, sr, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    ours = tresample_mod.resample(torch.as_tensor(x), sr, 24000).numpy()
    theirs = np.asarray(jresample_mod.resample(jnp.asarray(x), sr, 24000))
    assert ours.shape == theirs.shape == (2, -(-n * 24000 // sr))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_resample_identity_taps_and_numpy_wrapper(rng):
    x = rng.standard_normal((500,)).astype(np.float32)
    np.testing.assert_array_equal(tresample_mod.resample(torch.as_tensor(x), 24000, 24000).numpy(), x)
    np.testing.assert_array_equal(tresample_mod._kaiser_sinc_filter(80, 147), jresample_mod._kaiser_sinc_filter(80, 147))
    ours = tresample_mod.resample_np(x, 16000, 24000)
    assert isinstance(ours, np.ndarray) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, jresample_mod.resample_np(x, 16000, 24000), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the ConvNeXt block's wrapper


@pytest.fixture(scope="module")
def block():
    import jax

    cfg = JModelConfig(vocos_dim=128, vocos_ff=256, vocos_layers=1)
    p = jvocos.init(jax.random.PRNGKey(0), cfg)["blocks"][0]
    # The seeded layer scale (1e-2) would hide the MLP behind the residual.
    p = dict(p, gamma=jnp.full_like(p["gamma"], 0.5), dw_b=p["dw_b"] + 0.1)
    names = ("dw", "dw_b", ("ln", "g"), ("ln", "b"), ("pw1", "w"), ("pw1", "b"), ("pw2", "w"), ("pw2", "b"), "gamma")
    return [p[n] if isinstance(n, str) else p[n[0]][n[1]] for n in names]


def block_args(block):
    return [torch.as_tensor(np.array(a)) for a in block]


@pytest.mark.parametrize("b,t", [(2, 100), (1, 300)])
def test_convnext_block_plain_matches_pallas_f32(rng, block, b, t):
    x = rng.standard_normal((b, t, 128)).astype(np.float32)
    before = ops.launch_counts()["convnext_block"]
    ours = cb_op.convnext_block(torch.as_tensor(x), *block_args(block), bf16=False)
    assert ops.launch_counts()["convnext_block"] == before
    theirs = convnext_block_pallas(jnp.asarray(x), *block, interpret=True, bf16=False)
    assert ours.dtype == torch.float32
    close(ours, theirs)


@pytest.mark.parametrize("x_bf16", [False, True])
def test_convnext_block_plain_matches_pallas_bf16(rng, block, x_bf16):
    x = rng.standard_normal((2, 100, 128)).astype(np.float32)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    if x_bf16:
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)
    ours = cb_op.convnext_block(xt, *block_args(block), bf16=True)
    theirs = convnext_block_pallas(xj, *block, interpret=True, bf16=True)
    assert ours.dtype == xt.dtype  # the activation keeps x's dtype, whatever the MLP's
    assert np.asarray(theirs).dtype == (jnp.bfloat16 if x_bf16 else np.float32)
    diff = np.abs(ours.float().numpy() - np.asarray(theirs.astype(jnp.float32)))
    assert float(diff.max()) < 0.1
    assert float(diff.mean()) < 5e-3


@pytest.mark.parametrize("x_bf16", [False, True])
def test_tensor_core_epilogues_chained_are_the_block_mlp_half(rng, block, x_bf16):
    """The kernel's bf16-MLP route: dwconv + LN to bf16, then the shared GEMM with
    EPI_GELU_F32 (h in bf16) and EPI_GAMMA_RESID in x's dtype, f32 residual for an f32
    x. Equal to the plain block, and within the bf16 bound of the Pallas kernel."""
    dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma = block_args(block)
    x = torch.as_tensor(rng.standard_normal((2, 100, 128)).astype(np.float32))
    x = x.bfloat16() if x_bf16 else x
    normed = cb_op.dwconv_ln_plain(x, dw, dw_b, ln_g, ln_b, 1e-5, torch.bfloat16)
    h = gemm_op.gemm_tc(normed, w1.bfloat16(), gemm_op.EPI_GELU_F32, b1)
    ours = gemm_op.gemm_tc(h, w2.bfloat16(), gemm_op.EPI_GAMMA_RESID, b2, resid=x, gamma=gamma, out_dtype=x.dtype)
    plain = cb_op.convnext_block_plain(x, *block_args(block), bf16=True)
    assert ours.dtype == x.dtype
    assert float((ours.float() - plain.float()).abs().max()) <= (0.0 if x_bf16 else 1e-6)
    theirs = convnext_block_pallas(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x_bf16 else jnp.float32),
                                   *block, interpret=True, bf16=True)
    assert float(np.abs(ours.float().numpy() - np.asarray(theirs.astype(jnp.float32))).max()) < 0.1


def test_tensor_core_weight_copy_follows_the_tensor_not_its_address():
    """The bf16 [N, K] copies are cached per weight tensor: a write (a new `_version`)
    makes a new copy, and a new tensor never gets an old one's copy."""
    import gc

    w = torch.randn(64, 192)
    first = cb_op.tc_weight(w)
    assert cb_op.tc_weight(w) is first and torch.equal(first, w.bfloat16().t())
    w.mul_(2.0)
    assert torch.equal(cb_op.tc_weight(w), w.bfloat16().t())
    for _ in range(3):  # freed and reallocated tensors of the same shape
        del w
        gc.collect()
        w = torch.randn(64, 192)
        assert torch.equal(cb_op.tc_weight(w), w.bfloat16().t())


def test_tensor_core_weight_copy_dies_with_its_tensor():
    """A weight's cached copy is dropped when the weight is, not kept until the cache
    is full; a rewritten weight's entry is replaced, not added to."""
    import gc

    before = len(cb_op._TC_WEIGHTS)
    ws = [torch.randn(64, 128) for _ in range(4)]
    for w in ws:
        cb_op.tc_weight(w)
    ws[0].add_(1.0)
    cb_op.tc_weight(ws[0])
    assert len(cb_op._TC_WEIGHTS) == before + 4
    del w, ws
    gc.collect()
    assert len(cb_op._TC_WEIGHTS) == before


def test_convnext_block_plain_equals_one_vocos_block(rng, block):
    """In f32 the block is `vocos._block_apply`, the function the stack loops over."""
    from gonova_tts_tpu_torch.models import vocos as tvocos

    dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma = block_args(block)
    p = {"dw": dw, "dw_b": dw_b, "ln": {"g": ln_g, "b": ln_b}, "pw1": {"w": w1, "b": b1},
         "pw2": {"w": w2, "b": b2}, "gamma": gamma}
    x = torch.as_tensor(rng.standard_normal((2, 50, 128)).astype(np.float32))
    ours = cb_op.convnext_block_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, bf16=False)
    np.testing.assert_allclose(ours.numpy(), tvocos._block_apply(p, x, torch.float32).numpy(), atol=2e-5, rtol=1e-5)
