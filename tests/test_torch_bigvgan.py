"""The port's BigVGAN-v2 family on the CPU, held to the plain float32 reference
(`reference/bigvgan.py`, written after the published BigVGAN code) at a tiny size:
channels 32, rates [2, 2], kernels [4, 4], AMP blocks of kernels [3, 7] at dilations
[1, 3]; seeded weights, with every bias and log-scale drawn away from 0 so that a
mixed-up channel or a dropped bias shows.

On the CPU `ops.snake_aa` runs its plain version; the kernel's own tests are in
`test_torch_cuda.py`. Tolerances are stated per test.
"""

import asyncio
import logging
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine
from gonova_tts_tpu_torch import ops
from gonova_tts_tpu_torch.models import bigvgan, layers, params, registry, tts
from gonova_tts_tpu_torch.ops import snake_aa
from gonova_tts_tpu_torch.service.memory_socket import MemorySocket
from gonova_tts_tpu_torch.text import pick_bucket, text_to_ids
from gonova_tts_tpu_torch.utils import Tracer, prof
from reference import bigvgan as ref

LSB16 = 1.0 / 32767.0
TINY = dict(upsample_initial_channel=32, upsample_rates=[2, 2], upsample_kernels=[4, 4],
            resblock_kernels=[3, 7], resblock_dilations=[[1, 3], [1, 3]], vocoder_family="bigvgan", n_mels=20)
# The served pipeline at a tiny width: the generator's rates multiply to the hop (256).
SERVED = dict(
    d_model=32, n_heads=2, d_ff=64, encoder_layers=1, decoder_layers=1, speaker_dim=32, n_mels=20,
    speaker_n_mels=16, vocoder_family="bigvgan", upsample_initial_channel=32, upsample_rates=[8, 8, 2, 2],
    upsample_kernels=[16, 16, 4, 4], resblock_kernels=[3, 7], resblock_dilations=[[1, 3], [1, 3]],
    compute_dtype="float32", device="cpu",
)
# No frame buckets: every pass decodes its token bucket's worst-case frame count.
ENGINE = dict(token_buckets=[32, 64], batch_buckets=[1, 4], max_batch=4, batch_window_ms=5.0,
              stream_chunk_frames=24, stream_context_frames=12, warmup_shapes=[[1, 32]], vocode_frame_buckets=[])
TEXT = "The quiet river ran past the old mill."
# The published stage structure (rates, kernels, AMP blocks) at 512 channels: every
# stage's width (256 ... 8) a multiple of 8, as the published ones (768 ... 24) are.
NARROW = dict(upsample_initial_channel=512, upsample_rates=[4, 4, 2, 2, 2, 2], upsample_kernels=[8, 8, 4, 4, 4, 4],
              resblock_kernels=[3, 7, 11], resblock_dilations=[[1, 3, 5]] * 3, vocoder_family="bigvgan", n_mels=20)
PUBLISHED = dict(upsample_initial_channel=1536, upsample_rates=[4, 4, 2, 2, 2, 2],
                 upsample_kernels=[8, 8, 4, 4, 4, 4], resblock_kernels=[3, 7, 11],
                 resblock_dilations=[[1, 3, 5]] * 3, vocoder_family="bigvgan", n_mels=100, speaker_n_mels=80)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


def tree_of(module):
    """A port module's parameters as the nested tree the reference reads."""
    return params.unflatten({k.replace(".", "/"): v for k, v in module.state_dict().items()})


def seeded(cfg: ModelConfig, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    m = bigvgan.init(g, cfg)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 1:  # biases and log-scales: away from 0
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return m


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(**TINY)
    m = seeded(cfg)
    return cfg, m, ref.BigVGAN(tree_of(m), cfg.upsample_rates, cfg.resblock_dilations)


# ---------------------------------------------------------------- the activation


def test_filter_taps_are_the_formulas():
    """The 12 taps: Kaiser window (beta 0.1102 (A - 8.7), A = 2.285 * 5 * pi * 1.2 + 7.95)
    times 0.5 sinc(0.5 t) at t = -5.5 ... 5.5, over their sum; worked in float64 here,
    against the float32 taps within 1e-7; symmetric and summing to 1."""
    f = snake_aa.kaiser_sinc_filter()
    a = 2.285 * 5 * math.pi * 1.2 + 7.95
    beta = 0.1102 * (a - 8.7)
    assert a == pytest.approx(51.02, abs=0.01) and beta == pytest.approx(4.664, abs=1e-3)
    n = np.arange(12)
    window = np.i0(beta * np.sqrt(1 - ((2 * n - 11) / 11.0) ** 2)) / np.i0(beta)
    want = window * 0.5 * np.sinc(0.5 * (n - 5.5))
    want /= want.sum()
    assert f.dtype == torch.float32 and f.shape == (12,)
    np.testing.assert_allclose(f.numpy(), want, atol=1e-7, rtol=0)
    assert torch.equal(f, f.flip(0))
    assert float(f.double().sum()) == pytest.approx(1.0, abs=1e-6)
    assert torch.equal(f, ref.kaiser_sinc_filter1d(0.25, 0.3, 12).flatten())


@pytest.mark.parametrize("t", [1, 2, 5, 13, 40])
@pytest.mark.parametrize("c", [3, 8])
def test_activation_equals_the_references_activation1d(t, c):
    """The plain version (polyphase, pads as clamped indices) equals UpSample1d →
    SnakeBeta → DownSample1d within 2e-6 of the output's scale (f32 summation order);
    at T = 1 and 2 every output reads the replicated edges of both pads."""
    g = torch.Generator().manual_seed(100 * t + c)
    x = torch.randn((2, t, c), generator=g) * 3.0
    p = {"alpha": torch.randn(c, generator=g) * 0.5, "beta": torch.randn(c, generator=g) * 0.5}
    got = snake_aa.snake_aa(x, *snake_aa.constants(p["alpha"], p["beta"]))
    want = ref.Activation1d(p)(x.transpose(1, 2)).transpose(1, 2)
    assert got.shape == x.shape
    assert float((got - want).abs().max()) <= 2e-6 * max(1.0, float(want.abs().max()))


def test_activation_reads_either_layout_and_keeps_the_dtype():
    """[B, T, C] contiguous or lying as [B, C, T] (what `layers.conv1d` returns): one
    answer; bf16 in, bf16 out."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 17, 6), generator=g)
    consts = snake_aa.constants(torch.randn(6, generator=g), torch.randn(6, generator=g))
    rows = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(snake_aa.snake_aa(x, *consts), snake_aa.snake_aa(rows, *consts))
    assert snake_aa.snake_aa(x.bfloat16(), *consts).dtype == torch.bfloat16


def test_the_activations_bias_is_added_as_the_input_loads():
    """`bias` (the conv before it leaves its bias to the activation) is x + bias,
    summed in f32 before the upsampler: equal to adding it first, bit for bit."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 23, 5), generator=g)
    bias = torch.randn(5, generator=g)
    consts = snake_aa.constants(torch.randn(5, generator=g), torch.randn(5, generator=g))
    assert torch.equal(snake_aa.snake_aa(x, *consts, bias), snake_aa.snake_aa(x + bias, *consts))


def test_the_published_configuration_runs_109_activations_and_112_4m_parameters():
    """Counted without building the 112 M weights: conv_pre 1.08 M, ups 12.2 M, AMP
    convs 126 * sum(C^2) = 99.1 M plus their biases, alpha and beta 2 a channel an
    activation, conv_post 7 * 24."""
    cfg = ModelConfig(**PUBLISHED)
    assert bigvgan.activations(cfg) == 109
    with torch.device("meta"):
        m = bigvgan.init(torch.Generator(), cfg)
    chans = [1536 // 2 ** (i + 1) for i in range(6)]
    by_hand = (7 * 100 * 1536 + 1536
               + sum(k * 2 * c * c + c for k, c in zip([8, 8, 4, 4, 4, 4], chans))
               + sum(126 * c * c + 18 * c for c in chans)
               + sum(36 * c for c in chans) + 2 * 24 + 7 * 24)
    assert sum(p.numel() for p in m.parameters()) == by_hand == 112_414_512


def test_a_forward_calls_the_activation_once_per_activation(tiny, monkeypatch):
    cfg, m, _ = tiny
    calls = []
    real = snake_aa.snake_aa
    monkeypatch.setattr(snake_aa, "snake_aa", lambda x, *a: calls.append(x.shape) or real(x, *a))
    m(torch.zeros((1, 6, 20)))
    assert len(calls) == bigvgan.activations(cfg) == 2 * 2 * 4 + 1


# ---------------------------------------------------------------- the channels-last convs

# Even and odd lengths; below, at and above one phase row of dilations 3 and 5.
CONV_LENGTHS = [2, 3, 16, 37]


def _conv_node(seed: int, k: int, cin: int, cout: int, bias: bool = True):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((k, cin, cout), generator=g)
    return layers.leaf(w=w, b=torch.randn(cout, generator=g)) if bias else layers.leaf(w=w)


def _close(got, want, contiguous=True):
    assert got.shape == want.shape and got.is_contiguous() == contiguous
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("t", CONV_LENGTHS)
@pytest.mark.parametrize("k,d", [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)])
def test_channels_last_convs_equal_the_channels_first_conv_in_f32(k, d, t):
    """Every (k, d) of the published AMP blocks: `conv1d_nwc` gives `layers.conv1d`'s
    SAME dilated conv, [B, T, C_out] contiguous, within 1e-5 of the output's scale
    (f32 summation order); with `bias=False`, and `conv1d_phased`, the same less the
    bias. Each call counts once in `conv_nwc`, the phased one also in `conv_phased`."""
    p = _conv_node(100 * k + 10 * d + t, k, 6, 8)
    x = torch.randn((2, t, 6), generator=torch.Generator().manual_seed(t))
    want = layers.conv1d(p, x, dilation=d)
    before = ops.launch_counts()
    _close(layers.conv1d_nwc(p, x, dilation=d), want)
    for got in (layers.conv1d_nwc(p, x, dilation=d, bias=False), layers.conv1d_phased(p, x, d)):
        _close(got + p["b"], want)
    after = ops.launch_counts()
    assert after["conv_nwc"] - before["conv_nwc"] == 3 and after["conv_phased"] - before["conv_phased"] == 1


@pytest.mark.parametrize("t", CONV_LENGTHS)
@pytest.mark.parametrize("k,rate", [(8, 4), (4, 2)])
def test_channels_last_transposed_conv_equals_conv1d_transpose_in_f32(k, rate, t):
    """Both transposed rates of the published generator: `conv1d_transpose_nwc` gives
    `layers.conv1d_transpose` (taps reversed, output T * rate) less the bias,
    contiguous."""
    p = _conv_node(10 * k + t, k, 6, 8)
    x = torch.randn((2, t, 6), generator=torch.Generator().manual_seed(t))
    _close(layers.conv1d_transpose_nwc(p, x, rate) + p["b"], layers.conv1d_transpose(p, x, rate))


@pytest.mark.parametrize("k,d", [(7, 1), (4, 1), (4, 3), (8, 5)])
def test_channels_last_conv_pads_as_same_with_and_without_a_bias_node(k, d):
    """`conv_pre` / `conv_post` (k = 7, `conv_post` 1 channel out with no bias) and
    even kernels, whose SAME padding at an odd span is one more on the right:
    `layers.conv1d`'s. Output channels short of a multiple of 8 run padded with zero
    filters and come back as a view of the first C_out (the phase split too)."""
    x = torch.randn((2, 13, 6), generator=torch.Generator().manual_seed(k * d))
    p = _conv_node(k * d, k, 6, 16)
    _close(layers.conv1d_nwc(p, x, dilation=d), layers.conv1d(p, x, dilation=d))
    p = _conv_node(k * d, k, 6, 3)
    _close(layers.conv1d_nwc(p, x, dilation=d), layers.conv1d(p, x, dilation=d), contiguous=False)
    assert layers._nwc_weights(p, torch.float32)[0].shape == (8, 6, 1, k)
    if k % 2:
        _close(layers.conv1d_phased(p, x, d) + p["b"], layers.conv1d(p, x, dilation=d))
    q = _conv_node(k * d, k, 6, 1, bias=False)
    _close(layers.conv1d_nwc(q, x, dilation=d), layers._conv1d(q["w"], x, 1, torch.float32, 1, d), contiguous=False)


def test_every_activation_of_a_forward_reads_channels_last(monkeypatch):
    """The published stage structure at 512 channels, every dilated conv phase-split:
    each of the 109 activations receives x [B, T, C] contiguous, from the first
    stage's [2, 3 · 4, 256] on; the forward counts 116 convs in `conv_nwc` (36 of them
    also in `conv_phased`)."""
    cfg = ModelConfig(**NARROW)
    m = seeded(cfg)
    seen = []
    real = snake_aa.snake_aa

    def checked(x, *args):
        assert x.is_contiguous(), x.stride()
        seen.append(tuple(x.shape))
        return real(x, *args)

    monkeypatch.setattr(snake_aa, "snake_aa", checked)
    monkeypatch.setattr(bigvgan, "phase_split", lambda c, k, d: d > 1)
    before = ops.launch_counts()
    wav = m(torch.randn((2, 3, 20), generator=torch.Generator().manual_seed(0)))
    after = ops.launch_counts()
    assert wav.shape == (2, 3 * 256) and bool(torch.isfinite(wav).all())
    assert len(seen) == bigvgan.activations(cfg) == 109
    assert seen[0] == (2, 12, 256) and seen[-1] == (2, 768, 8)
    assert after["conv_nwc"] - before["conv_nwc"] == bigvgan.convs(cfg) == 116
    assert after["conv_phased"] - before["conv_phased"] == 6 * 3 * 2


def test_packed_conv_weights_are_built_once_per_dtype_and_rebuilt_after_clear_derived():
    """A forward that takes no gradient (serving) packs each conv's weight once per
    (dtype, device) on its node (the cast channels-last filter and the cast bias) and
    later forwards reuse it: a weight changed in place serves stale until
    `clear_derived`, after which the forward rebuilds it and equals the reference at
    the new weights."""
    cfg = ModelConfig(**TINY)
    m = seeded(cfg, 7)
    mel = torch.randn((2, 9, 20), generator=torch.Generator().manual_seed(1))
    conv, up = m.conv_pre, m.ups[0]
    key = ("conv_nwc", torch.float32, conv.w.device, False)
    with torch.no_grad():
        first = m(mel)
        packed = conv.__dict__["_derived"][key]
        m(mel)
        m(mel, torch.bfloat16)
        memo = conv.__dict__["_derived"]
        assert memo[key] is packed
        assert {k[1] for k in memo if k[0] == "conv_nwc"} == {torch.float32, torch.bfloat16}
        w, b = packed
        k, cin, cout = conv.w.shape
        assert w.shape == (cout, cin, 1, k) and w.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(w[:, :, 0], conv.w.permute(2, 1, 0)) and torch.equal(b, conv.b)
        wt, _ = up.__dict__["_derived"][("conv_nwc", torch.float32, up.w.device, True)]
        assert wt.shape == (up.w.shape[1], up.w.shape[2], 1, up.w.shape[0])
        assert wt.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(wt[:, :, 0], up.w.flip(0).permute(1, 2, 0))
        conv.w.mul_(3.0)
        assert torch.equal(m(mel), first)
        layers.clear_derived(m)
        again = m(mel)
        assert conv.__dict__["_derived"][key] is not packed
        want = ref.BigVGAN(tree_of(m), cfg.upsample_rates, cfg.resblock_dilations)(mel)
        assert float((again - want).abs().max()) <= 1e-5 and float((again - first).abs().max()) > 1e-4


def test_a_forward_that_takes_gradients_reaches_every_weight_after_a_packed_one():
    """A critic's step runs the generator under `no_grad`, which packs its weights; the
    generator's own step after it (its parameters trainable, as the trainer sets
    them) takes gradients, so it packs afresh and nothing is
    memoized: every parameter, conv weights, biases and log-scales, gets a gradient,
    the same as from a generator that never served a packed forward."""
    cfg = ModelConfig(**TINY)
    m, fresh = seeded(cfg, 3).requires_grad_(True), seeded(cfg, 3).requires_grad_(True)
    mel = torch.randn((2, 9, 20), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        m(mel)
    assert "_derived" in m.conv_pre.__dict__
    memo = dict(m.conv_pre.__dict__["_derived"])
    for gen in (m, fresh):
        (gen(mel) ** 2).sum().backward()
    now = m.conv_pre.__dict__["_derived"]
    assert now.keys() == memo.keys() and all(now[k] is memo[k] for k in memo)
    for (name, p), q in zip(m.named_parameters(), fresh.parameters()):
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- the generator


@pytest.mark.parametrize("t", [1, 2, 5, 13, 40])
def test_generator_equals_the_reference_in_f32(tiny, t):
    """Both are f32 sums of the same products in the [B, C, T] convs; the activation's
    order differs, so within 1e-5 absolute (outputs ~0.1)."""
    cfg, m, reference = tiny
    mel = torch.randn((2, t, 20), generator=torch.Generator().manual_seed(t)) * 2.0
    got, want = bigvgan.forward(m, mel, cfg), reference(mel)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 4 * t)
    assert float(want.abs().max()) > 1e-3
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("t", [1, 2, 5, 13, 40])
def test_generator_with_every_dilated_conv_phase_split_equals_the_reference_in_f32(tiny, t, monkeypatch):
    """`test_generator_equals_the_reference_in_f32` with the phase split forced on for
    every dilated conv (2 stages x 2 blocks x dilation 3), each counted once."""
    from gonova_tts_tpu_torch import ops

    cfg, m, reference = tiny
    monkeypatch.setattr(bigvgan, "phase_split", lambda c, k, d: d > 1)
    mel = torch.randn((2, t, 20), generator=torch.Generator().manual_seed(t)) * 2.0
    before = ops.launch_counts()["conv_phased"]
    got, want = bigvgan.forward(m, mel, cfg), reference(mel)
    dilated = len(cfg.upsample_rates) * sum(d > 1 for rd in cfg.resblock_dilations for d in rd)
    assert ops.launch_counts()["conv_phased"] - before == dilated == len(bigvgan.phased_convs(cfg)) == 4
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 4 * t)
    assert float((got - want).abs().max()) <= 1e-5


def test_the_phase_split_engages_the_tables_convs_at_the_published_widths():
    """The rule picks, of every (C, k, d) the published generator runs, exactly the
    convs that the per-conv table in PERF.md §6 shows cuDNN running as its CUDA-core
    implicit GEMM when dilated: 768, 384 and 192 channels with (k - 1) d >= 30."""
    cfg = ModelConfig(**PUBLISHED)
    grid = {(1536 // 2 ** (i + 1), k, d) for i in range(6) for k in (3, 7, 11) for d in (1, 3, 5)}
    table = {(c, k, d) for c in (768, 384, 192) for k, d in ((7, 5), (11, 3), (11, 5))}
    assert {s for s in grid if bigvgan.phase_split(*s)} == table
    assert sorted(bigvgan.phased_convs(cfg)) == sorted(table) and len(bigvgan.phased_convs(cfg)) == 9
    assert not bigvgan.phased_convs(ModelConfig(**TINY))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generator_in_bf16_stays_within_its_bound(seed):
    """bf16 rounds every conv's operands and output and each activation's output
    (2^-9 relative each) through ~10 layers in sequence and residual sums: the
    waveform within 3% of the reference's peak. A float8 rounding of the same
    operands (2^-4 each) reads several times that."""
    cfg = ModelConfig(**TINY)
    m = seeded(cfg, seed + 10)
    reference = ref.BigVGAN(tree_of(m), cfg.upsample_rates, cfg.resblock_dilations)
    mel = torch.randn((2, 48, 20), generator=torch.Generator().manual_seed(seed)) * 2.0
    want = reference(mel)
    got = bigvgan.forward(m, mel, cfg, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 0.03 * float(want.abs().max())


def test_registry_and_npz_round_trip(tiny, tmp_path):
    """`registry.get("bigvgan")` builds and runs the family; a whole TTS tree saved to
    an npz ('/'-joined paths) loads back through `params.load_checkpoint`, strictly,
    and speaks the same samples."""
    cfg, _, _ = tiny
    fam = registry.get("bigvgan")
    assert fam.kind == "vocoder" and fam.forward is bigvgan.forward
    m = fam.init(torch.Generator().manual_seed(3), cfg)
    mel = torch.randn((1, 9, 20))
    assert torch.equal(fam.forward(m, mel, cfg), m(mel))

    full = ModelConfig(**SERVED)
    model = tts.TTS(full, torch.Generator().manual_seed(4))
    path = str(tmp_path / "bigvgan.npz")
    np.savez(path, **{k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()})
    assert "vocoder/acts/1/0/a2/1/alpha" in np.load(path).files
    assert "vocoder/conv_post/b" not in np.load(path).files  # no bias at the last conv
    loaded, _ = params.load_checkpoint(path, full, device="cpu")
    for (k, a), (k2, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    mel = torch.randn((1, 5, 20))
    assert torch.equal(tts.vocode(model, mel, full), tts.vocode(loaded, mel, full))
    with pytest.raises(ValueError):
        params.load_checkpoint(path, full.model_copy(update={"vocoder_family": "hifigan"}), device="cpu")


def test_stage_ranges_open_only_under_a_recorded_span_and_a_profiler(tiny):
    cfg, m, _ = tiny
    mel = torch.zeros((1, 4, 20))

    def names(tracer):
        with profile(activities=[ProfilerActivity.CPU]) as p:
            with tracer.span("engine.pass"):
                m(mel)
        return {e.name for e in p.events() if e.name.startswith("gonova.bigvgan.")}

    assert names(Tracer(on=True)) == {"gonova.bigvgan.up0", "gonova.bigvgan.amp0", "gonova.bigvgan.up1",
                                     "gonova.bigvgan.amp1"}
    assert names(Tracer(on=False)) == set()
    with Tracer(on=True).span("engine.pass"):
        assert not isinstance(prof.stage("x"), torch.profiler.record_function)  # no profiler records


def test_reach_frames_per_family():
    """The frames each side one sample can depend on, worked by hand from the layers:
    BigVGAN-v2 3 (conv_pre) + 1.25 + 0.3125 + 0.0625 + 1/32 + 1/64 + 1/128 (the
    transposed convs) + 90 * (1/4 + 1/16 + 1/32 + 1/64 + 1/128 + 1/256) (the widest AMP
    block: its six activations of 5 samples, 5 * (1 + 3 + 5) + 5 * 3 of its convs) +
    8/256 (act_post, conv_post) = 38.11 → 39; HiFi-GAN V1 at 24 kHz → 14; Vocos at 8
    layers: the JAX engine's 3 * 9 + 2 = 29."""
    assert tts.reach_frames(ModelConfig(**PUBLISHED)) == 39
    assert tts.reach_frames(ModelConfig(vocoder_family="hifigan", upsample_initial_channel=512)) == 14
    assert tts.reach_frames(ModelConfig()) == 29
    assert snake_aa.REACH == 5


@pytest.mark.parametrize("widths", [{}, dict(upsample_rates=[8, 8, 2, 2], upsample_kernels=[16, 16, 4, 4])])
def test_reach_frames_bounds_the_generator(widths, monkeypatch):
    """The bound is the generator's: with every tap positive (conv weights and the
    filter's magnitudes), the activation linear (alpha ~ 0) and no clamp, a change to
    one mel frame reaches every output sample that structurally depends on it, and
    the farthest frame it reaches is `reach_frames` or one less (the rounding up)."""
    cfg = ModelConfig(**{**TINY, **widths})
    f = snake_aa._taps_host()[0].abs()
    monkeypatch.setattr(snake_aa, "_taps_host", lambda: (f, None))
    m = bigvgan.init(torch.Generator().manual_seed(0), cfg).double()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("alpha"):
                p.fill_(-200.0)
            elif p.dim() == 1:
                p.zero_()
            else:  # each conv an average: no sample reaches the clamp, none underflows
                p.fill_(1.0 / (p.shape[0] * p.shape[1]))
    t, at = 200, 100
    mel = torch.zeros((1, t, 20), dtype=torch.float64)
    bumped = mel.clone()
    bumped[0, at] = 1.0
    with torch.no_grad():
        moved = (bigvgan.forward(m, bumped, cfg, torch.float64) != bigvgan.forward(m, mel, cfg, torch.float64))
    frames = moved.reshape(t, -1).any(dim=1).nonzero().flatten()
    reach = bigvgan.reach_frames(cfg)
    assert reach - 1 <= at - int(frames.min()) <= reach and reach - 1 <= int(frames.max()) - at <= reach


def test_the_warm_up_warns_below_the_generators_reach(checkpoint, caplog):
    """A stream context below `tts.reach_frames` (11 at this width) is reported."""
    eng = TTSEngine(_config(checkpoint, stream_context_frames=8), device="cpu")
    with caplog.at_level(logging.WARNING, logger="gonova_tts_tpu_torch.engine"):
        eng.load(warmup=True)
    assert any("below the exactness bound 11" in r.getMessage() for r in caplog.records)


# ---------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The served pipeline's npz, its generator drawn loud enough for PCM16: each conv
    N(0, 1 / (k C_in)), biases and log-scales N(0, 0.25)."""
    model = tts.TTS(ModelConfig(**SERVED), torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, p in model.vocoder.named_parameters():
            std = 0.5 if p.dim() == 1 else 1.0 / math.sqrt(p.shape[0] * p.shape[1])
            p.copy_(torch.randn(p.shape, generator=g) * std)
    path = str(tmp_path_factory.mktemp("bigvgan") / "served.npz")
    np.savez(path, **{k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()})
    return path


def _config(path, **engine) -> Config:
    cfg = Config()
    cfg.model = ModelConfig(**SERVED, model_path=path)
    cfg.engine = EngineConfig(**{**ENGINE, **engine})
    cfg.logging.level = "WARNING"
    cfg.voice_cloning.default_voice_path = None
    return cfg


@pytest.fixture(scope="module")
def engine(checkpoint):
    eng = TTSEngine(_config(checkpoint), device="cpu")
    eng.load(warmup=True)
    return eng


def test_engine_serves_what_tts_synthesize_speaks(engine):
    """A pass at the worst-case frame count: the engine's PCM16 equals `tts.synthesize`
    at the sentence's token bucket within two int16 steps (the transfer truncates, one step, and
    unpacks by 1/32768 what it packed by 32767, another step at full scale);
    `kernel_launches` rides in `get_stats()`."""
    ids = text_to_ids(TEXT)
    bucket = pick_bucket(len(ids), engine.ecfg.token_buckets)
    tokens = torch.zeros((1, bucket), dtype=torch.long)
    tokens[0, : len(ids)] = torch.as_tensor(ids)
    mask = (torch.arange(bucket)[None] < len(ids)).float()
    with torch.inference_mode():
        out = tts.synthesize(engine.params, tokens, mask, torch.zeros((1, 32)), torch.full((1,), 0.5), engine.mcfg)
    want = out["audio"][0, : int(out["total_samples"][0])].numpy()
    (got,) = engine.synthesize_batch([TEXT])
    assert got.dtype == np.float32 and got.shape == want.shape and np.abs(want).max() > 100 * LSB16
    np.testing.assert_allclose(got, want, atol=2.01 * LSB16, rtol=0)
    assert "snake_aa" in engine.get_stats()["kernel_launches"]


def test_two_stage_passes_keep_the_generators_reach_past_the_longest_sentence(checkpoint):
    """With a 1-frame stream context and a frame bucket for every length, a two-stage
    pass still vocodes at least `tts.reach_frames` (11 here) frames past the batch's
    longest sentence, so its last samples do not see the bucket's edge: the engine's
    PCM16 equals the one-shot `tts.synthesize` at the whole token bucket within three
    int16 steps (two as above, and the f32 noise of a decode at another length, 0.2
    step). With only the stream context past it, the last three frames missed by 96 to
    18,000 steps."""
    eng = TTSEngine(_config(checkpoint, stream_context_frames=1, vocode_frame_buckets=list(range(8, 256))),
                    device="cpu")
    eng.load(warmup=False)
    assert tts.reach_frames(eng.mcfg) == 11
    ids = text_to_ids(TEXT)
    bucket = pick_bucket(len(ids), eng.ecfg.token_buckets)
    tokens = torch.zeros((1, bucket), dtype=torch.long)
    tokens[0, : len(ids)] = torch.as_tensor(ids)
    mask = (torch.arange(bucket)[None] < len(ids)).float()
    with torch.inference_mode():
        out = tts.synthesize(eng.params, tokens, mask, torch.zeros((1, 32)), torch.full((1,), 0.5), eng.mcfg)
    want = out["audio"][0, : int(out["total_samples"][0])].numpy()
    (got,) = eng.synthesize_batch([TEXT])
    assert eng.get_stats()["vocode_frames_executed"] == len(want) // 256 + 11
    np.testing.assert_allclose(got, want, atol=3 * LSB16, rtol=0)


def test_engine_streams_a_sentence(engine):
    """`synthesize_stream` runs BigVGAN window by window: as long as the one-shot audio
    and close to it. The stream context (12 frames here) covers the generator's reach
    at this width (11 frames); at the published widths (39) the configured 29 do not,
    and the engine warns at warm-up."""
    (one_shot,) = engine.synthesize_batch([TEXT])
    chunks = list(engine.synthesize_stream(TEXT))
    streamed = np.concatenate(chunks)
    assert len(chunks) >= 2 and streamed.shape == one_shot.shape and np.isfinite(streamed).all()
    assert np.abs(streamed - one_shot).mean() < 0.25 * np.abs(one_shot).mean()


def test_a_100_band_vocoder_beside_an_80_band_voice_path(engine):
    """`speaker_n_mels` sets the speaker encoder's input and the voice log-mel; the
    acoustic head and the vocoder keep `n_mels`."""
    assert engine.params.speaker.c1.w.shape == (5, 16, 256)
    assert engine.params.acoustic.mel_out.w.shape == (32, 20)
    assert engine.params.vocoder.conv_pre.w.shape == (7, 20, 32)
    audio = (0.2 * np.sin(np.arange(36000) * 2 * np.pi * 180 / 24000)).astype(np.float32)
    emb = engine.embed_voice(audio, 24000)
    assert emb.shape == (32,) and abs(float(np.linalg.norm(emb)) - 1.0) < 1e-5
    (cloned,) = engine.synthesize_batch([TEXT], speakers=[emb])
    assert np.abs(cloned).max() > 100 * LSB16


def test_service_serves_rest_and_websocket(checkpoint, tmp_path):
    """TTSService → DynamicBatcher → synthesize_batch at vocoder_family bigvgan: the
    REST body and the WebSocket's float32 frames carry the same samples."""
    from gonova_tts_tpu_torch.service.server import TTSService

    cfg = _config(checkpoint)
    cfg.voice_cloning.cache_dir = str(tmp_path / "voices")

    async def run():
        svc = TTSService(cfg)
        await svc.start()
        try:
            full = await svc.synthesize_full(TEXT)
            sock = MemorySocket()
            conn = asyncio.create_task(svc.handle_connection(sock, "bigvgan-0"))
            _, frames = await sock.request({"type": "synthesize", "text": TEXT}, ("synthesis_complete", "error"))
            await sock.end()
            await conn
            return full, frames, svc.metrics_prometheus()
        finally:
            await svc.shutdown()

    full, frames, text = asyncio.run(run())
    assert frames[-1][2]["type"] == "synthesis_complete"
    ws = np.concatenate([np.frombuffer(p, np.float32) for _, kind, p in frames if kind == "binary"])
    assert full.shape == ws.shape and np.abs(full).max() > 100 * LSB16
    np.testing.assert_array_equal(full, ws)
    assert "gonova_tts_kernel_launches_snake_aa" in text


# ---------------------------------------------------------------- other families untouched


def test_speaker_n_mels_none_leaves_the_config_and_the_other_families():
    """Config() is the JAX package's, field for field, with speaker_n_mels None; the
    voice path reads n_mels then, and NovaVocos's and HiFi-GAN's trees keep the
    shapes of the JAX package's init."""
    import jax

    from gonova_tts_tpu.models import tts as jtts

    cfg = ModelConfig()
    assert cfg.speaker_n_mels is None and cfg.voice_n_mels == cfg.n_mels == 80
    # the port's own fields: the voice path's bands, and the F5 family's (acoustic_family "nova" by default)
    port_only = {"speaker_n_mels", "acoustic_family"} | {k for k in ModelConfig.model_fields if k.startswith("f5_")}
    assert cfg.acoustic_family == "nova"
    assert cfg.model_dump(exclude={"device"} | port_only) == JModelConfig().model_dump(exclude={"device"})
    small = dict(d_model=32, n_heads=2, d_ff=64, encoder_layers=1, decoder_layers=1, speaker_dim=32,
                 vocos_dim=32, vocos_ff=64, vocos_layers=1, upsample_initial_channel=32)
    for family in ("vocos", "hifigan"):
        ours = {k.replace(".", "/"): tuple(v.shape)
                for k, v in tts.TTS(ModelConfig(**small, vocoder_family=family)).state_dict().items()}
        theirs = jtts.init(jax.random.PRNGKey(0), JModelConfig(**small, vocoder_family=family))
        flat = {k: tuple(np.shape(v)) for k, v in params.flatten(theirs).items()}
        assert ours == flat, family
