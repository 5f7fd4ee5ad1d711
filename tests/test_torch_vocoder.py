"""The port's HiFi-GAN family vs the JAX package's, f32 on the CPU: dilated and
transposed convs, the generator in both layouts, the MPD/MSD critics, the pipeline,
the `novagan` registry family, checkpoints and the engine.

Both sides get one seeded tree (made by the port's initializers, handed to JAX as
numpy and loaded back through `params.from_numpy_tree` /
`discriminators_from_numpy`) and the same numpy inputs; the JAX side runs jitted.
Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.config import Config as JConfig
from gonova_tts_tpu.config import EngineConfig as JEngineConfig
from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.engine import TTSEngine as JTTSEngine
from gonova_tts_tpu.models import layers as jlayers
from gonova_tts_tpu.models import tts as jtts
from gonova_tts_tpu.models import vocoder as jvocoder
from gonova_tts_tpu.models import vocoder_folded as jfolded
from gonova_tts_tpu.text import text_to_ids
from gonova_tts_tpu.train import checkpoint as jckpt
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine
from gonova_tts_tpu_torch.models import layers, params, registry, tts, vocoder, vocoder_folded

LSB16 = 1.0 / 32767.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


def leaf(rng, k, cin, cout):
    return {"w": rng.normal(size=(k, cin, cout)).astype(np.float32), "b": rng.normal(size=cout).astype(np.float32)}


def numpy_tree(module):
    """A port module's parameters as the JAX layout's nested numpy tree."""
    return params.unflatten({k.replace(".", "/"): v.numpy() for k, v in module.state_dict().items()})


def both(p):
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.as_tensor(v) for k, v in p.items()}


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_conv1d_dilation_matches_jax(k, d):
    """SAME padding over the dilated kernel, XLA's rule, rtol 1e-5 (atol 1e-5 for
    sums that cancel)."""
    rng = np.random.default_rng(k * 10 + d)
    jp, tp = both(leaf(rng, k, 6, 5))
    x = rng.normal(size=(2, 37, 6)).astype(np.float32)
    want = np.asarray(jlayers.conv1d(jp, jnp.asarray(x), dilation=d))
    got = layers.conv1d(tp, torch.as_tensor(x), dilation=d).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k, s", [(16, 8), (4, 2)])
def test_conv1d_transpose_matches_jax(k, s):
    """Output length exactly T * s and JAX's orientation (its kernel unflipped),
    rtol 1e-5 (atol 1e-5); the unflipped F.conv_transpose1d is another function."""
    rng = np.random.default_rng(k)
    jp, tp = both(leaf(rng, k, 6, 5))
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    want = np.asarray(jlayers.conv1d_transpose(jp, jnp.asarray(x), s))
    got = layers.conv1d_transpose(tp, torch.as_tensor(x), s).numpy()
    assert got.shape == want.shape == (2, 7 * s, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    unflipped = {"w": tp["w"].flip(0), "b": tp["b"]}
    assert np.abs(layers.conv1d_transpose(unflipped, torch.as_tensor(x), s).numpy() - want).max() > 0.1


@pytest.mark.parametrize("args", [
    (3, 8, 8, (-5, -2, 1)), (7, 4, 4, (-9, -6, -3, 0, 3, 6, 9)), (16, 16, 16, tuple(range(-11, 5))),
    (7, 8, 128, tuple(range(-3, 4))), (4, 2, 2, (-4, -1, 2, 5)),
])
def test_fold_selector_equals_jax(args):
    sel, lo = vocoder_folded._fold_selector(*args)
    want_sel, want_lo = jfolded._fold_selector(*args)
    assert lo == want_lo
    np.testing.assert_array_equal(sel, want_sel)


# ---------------------------------------------------------------- the generator


GEOMETRIES = {
    "production_t8": (dict(), 8),
    "narrow_t8": (dict(upsample_initial_channel=32), 8),
    "fallback_t7": (dict(), 7),
}


@pytest.fixture(scope="module")
def generators():
    """Per geometry: (port config, the port generator, mel, JAX plain, JAX folded)."""
    out = {}
    for name, (kw, t) in GEOMETRIES.items():
        jcfg = JModelConfig(vocoder_family="hifigan", **kw)
        cfg = ModelConfig(vocoder_family="hifigan", device="cpu", **kw)
        tree = numpy_tree(vocoder.init(torch.Generator().manual_seed(1), cfg))
        gen = params._load_strict(vocoder.init(torch.Generator().manual_seed(0), cfg), tree, "cpu")
        mel = np.random.default_rng(2).normal(size=(2, t, 80)).astype(np.float32)
        jt = jax.tree_util.tree_map(jnp.asarray, tree)
        run = lambda f: np.asarray(jax.jit(lambda p, m: f(p, m, jcfg))(jt, jnp.asarray(mel)))  # noqa: E731
        out[name] = (cfg, gen, mel, run(jvocoder.forward), run(jfolded.forward))
    return out


@pytest.mark.parametrize("layout", ["plain", "folded"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_generator_matches_jax(generators, geometry, layout):
    """vocoder.forward / vocoder_folded.forward against the same JAX function, and
    the folded layout against the port's plain one: atol 2e-5, rtol 1e-5 (the JAX
    package's pin for its own fold). The production geometry folds stages 2-4 and
    the 128-lane post conv; the narrow one folds every stage; T = 7 falls back."""
    cfg, gen, mel, want_plain, want_folded = generators[geometry]
    fn, want = (vocoder.forward, want_plain) if layout == "plain" else (vocoder_folded.forward, want_folded)
    got = fn(gen, torch.as_tensor(mel), cfg).numpy()
    assert got.shape == want.shape == (2, mel.shape[1] * vocoder.upsample_factor(cfg)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got, vocoder.forward(gen, torch.as_tensor(mel), cfg).numpy(), rtol=1e-5, atol=2e-5)


def test_folded_generator_serves_then_trains():
    """The fold's cached selector, first built under inference mode (serving), still
    enters a later backward pass (training) in the same process."""
    cfg = ModelConfig(vocoder_family="hifigan", upsample_initial_channel=32, upsample_rates=[8, 4, 2, 2],
                      upsample_kernels=[16, 8, 4, 4], device="cpu")
    vocoder_folded._selector_on.cache_clear()
    gen = vocoder.init(torch.Generator().manual_seed(6), cfg)
    mel = torch.as_tensor(np.random.default_rng(6).normal(size=(1, 8, 80)).astype(np.float32))
    with torch.inference_mode():
        served = vocoder_folded.forward(gen, mel, cfg)
    gen.requires_grad_(True)
    trained = vocoder_folded.forward(gen, mel, cfg)
    (trained**2).sum().backward()
    assert gen.conv_pre.w.grad is not None and torch.isfinite(gen.conv_pre.w.grad).all()
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=0)


# ---------------------------------------------------------------- the critics


@pytest.fixture(scope="module")
def critics():
    jt = numpy_tree(vocoder.discriminators_init(torch.Generator().manual_seed(2), torch.Generator().manual_seed(3), 0.25))
    return jt, params.discriminators_from_numpy(jt, 0.25, device="cpu")


@pytest.mark.parametrize("t", [8192, 6007])
@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_discriminators_match_jax(critics, which, t):
    """Logits and every feature tap of each sub-discriminator at width 0.25, for a
    segment and an odd length (the MPD's reflect pad), atol 1e-4."""
    jt, disc = critics
    wav = (0.3 * np.random.default_rng(t).normal(size=(1, t))).astype(np.float32)
    apply_j, apply_t = {"mpd": (jvocoder.mpd_apply, vocoder.mpd_apply), "msd": (jvocoder.msd_apply, vocoder.msd_apply)}[which]
    want = jax.jit(apply_j)(jax.tree_util.tree_map(jnp.asarray, jt[which]), jnp.asarray(wav))
    with torch.no_grad():
        got = apply_t(disc[which], torch.as_tensor(wav))
    assert len(got) == len(want) == (5 if which == "mpd" else 3)
    for (gl, gf), (wl, wf) in zip(got, want):
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4, rtol=0)
        assert len(gf) == len(wf)
        for a, b in zip(gf, wf):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_discriminators_from_numpy_is_strict(critics):
    jt, _ = critics
    with pytest.raises(ValueError, match="missing"):
        params.discriminators_from_numpy({"mpd": jt["mpd"], "msd": {"subs": jt["msd"]["subs"][:2]}}, 0.25, "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        params.discriminators_from_numpy(jt, 0.5, "cpu")
    extra = {"mpd": {**jt["mpd"], "extra": {"w": np.zeros(3, np.float32)}}, "msd": jt["msd"]}
    with pytest.raises(ValueError, match="unexpected"):
        params.discriminators_from_numpy(extra, 0.25, "cpu")


# ---------------------------------------------------------------- pipeline, registry, checkpoint


SMALL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocoder_family="hifigan", upsample_initial_channel=32, compute_dtype="float32",
)


@pytest.fixture(scope="module")
def small():
    cfg = ModelConfig(**SMALL, device="cpu")
    tree = numpy_tree(tts.TTS(cfg, torch.Generator().manual_seed(4)))
    return JModelConfig(**SMALL), tree, params.from_numpy_tree(tree, cfg, device="cpu")


def _tokens(texts, bucket):
    ids = [text_to_ids(t) for t in texts]
    tokens = np.zeros((len(ids), bucket), np.int32)
    for i, row in enumerate(ids):
        tokens[i, : len(row)] = row
    mask = (np.arange(bucket)[None] < np.asarray([len(r) for r in ids])[:, None]).astype(np.float32)
    return tokens, mask


def test_pipeline_matches_jax(small):
    """tts.synthesize, encode_acoustic + decode_vocode and vocode with the HiFi-GAN
    family (folded, the default): equal frame counts, audio atol 2e-5."""
    jcfg, tree, model = small
    cfg = model.cfg
    tokens, mask = _tokens(["Hello there, world.", "A second, longer sentence with 42 words."], 64)
    spk = np.random.default_rng(5).normal(size=(2, 32)).astype(np.float32) * 0.3
    exagg = np.asarray([0.5, 1.2], np.float32)
    jargs = [jnp.asarray(a) for a in (tokens, mask, spk, exagg)]
    targs = [torch.as_tensor(a) for a in (tokens, mask, spk, exagg)]
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jax.jit(lambda p, *a: jtts.synthesize(p, *a, jcfg))(jt, *jargs)
    ours = tts.synthesize(model, *targs, cfg)
    np.testing.assert_array_equal(ours["total_samples"].numpy(), np.asarray(ref["total_samples"]))
    np.testing.assert_allclose(ours["audio"].numpy(), np.asarray(ref["audio"]), atol=2e-5, rtol=0)
    enc_j = jax.jit(lambda p, *a: jtts.encode_acoustic(p, *a, jcfg))(jt, *jargs)
    enc_t = tts.encode_acoustic(model, *targs, cfg)
    fb = int(np.asarray(enc_j["total_frames"]).max()) + 8
    dv_j = jax.jit(lambda p, *a: jtts.decode_vocode(p, *a, fb, jcfg))(
        jt, enc_j["enc"], enc_j["spk"], enc_j["durations"], jargs[1])
    dv_t = tts.decode_vocode(model, enc_t["enc"], enc_t["spk"], enc_t["durations"], targs[1], fb, cfg)
    np.testing.assert_allclose(dv_t["audio"].numpy(), np.asarray(dv_j["audio"]), atol=2e-5, rtol=0)
    mel = np.array(ref["mel"])[:, :40]
    want = jax.jit(lambda p, m: jtts.vocode(p, m, jcfg))(jt, jnp.asarray(mel))
    np.testing.assert_allclose(tts.vocode(model, torch.as_tensor(mel), cfg).numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("folded", [True, False])
def test_registry_novagan_routes_by_hifigan_folded(small, folded):
    """`novagan` takes the layout `hifigan_folded` names, exactly (the same
    function), and matches the JAX family's forward (atol 2e-5)."""
    jcfg, tree, model = small
    cfg = model.cfg.model_copy(update={"hifigan_folded": folded})
    fam = registry.get("novagan")
    assert fam.kind == "vocoder" and isinstance(fam.init(torch.Generator().manual_seed(0), cfg), vocoder.Generator)
    mel = torch.as_tensor(np.random.default_rng(3).normal(size=(1, 8, 80)).astype(np.float32))
    via_registry = fam.forward(model.vocoder, mel, cfg, dtype=torch.float32)
    direct = (vocoder_folded.forward if folded else vocoder.forward)(model.vocoder, mel, cfg)
    torch.testing.assert_close(via_registry, direct, rtol=0, atol=0)
    from gonova_tts_tpu.models import registry as jregistry

    jcfg = jcfg.model_copy(update={"hifigan_folded": folded})
    want = jax.jit(lambda p, m: jregistry.get("novagan").forward(p, m, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, tree["vocoder"]), jnp.asarray(mel.numpy()))
    np.testing.assert_allclose(via_registry.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_hifigan_checkpoint_loads(small, tmp_path):
    """A JAX-written HiFi-GAN .npz: load_checkpoint keeps the config (no Vocos head
    to infer) and restores every leaf, nested lists included."""
    jcfg, tree, _ = small
    path = jckpt.save_params_npz(str(tmp_path / "g.npz"), tree, dtype="float32")
    cfg = ModelConfig(**SMALL, device="cpu")
    assert params.infer_vocos_head(tree, cfg) is cfg
    model, got_cfg = params.load_checkpoint(path, cfg, device="cpu")
    assert got_cfg == cfg
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    want = {k.replace("/", "."): v for k, v in params.flatten(tree).items()}
    assert sorted(state) == sorted(want) and "vocoder.mrfs.3.2.convs1.1.w" in state
    for k in want:
        np.testing.assert_array_equal(state[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="does not fit"):
        params.load_checkpoint(path, cfg.model_copy(update={"vocoder_family": "vocos"}), device="cpu")


# ---------------------------------------------------------------- the engine


ENGINE = dict(
    token_buckets=[32, 64, 128], batch_buckets=[1, 4], max_batch=4, stream_chunk_frames=24,
    stream_context_frames=12, warmup_shapes=[[1, 32]],
)
TEXTS = ["Hello there world.", "A second and much longer sentence for the batch, with 42 words."]


@pytest.fixture(scope="module")
def engines(small, tmp_path_factory):
    """Both engines serving one HiFi-GAN .npz (model.model_path)."""
    path = jckpt.save_params_npz(str(tmp_path_factory.mktemp("novagan") / "g.npz"), small[1], dtype="float32")
    port_cfg, ref_cfg = Config(), JConfig()
    port_cfg.model, port_cfg.engine = ModelConfig(**SMALL, model_path=path), EngineConfig(**ENGINE)
    ref_cfg.model, ref_cfg.engine = JModelConfig(**SMALL, model_path=path), JEngineConfig(**ENGINE)
    ref = JTTSEngine(ref_cfg)
    ref.load(warmup=False)
    port = TTSEngine(port_cfg, device="cpu")
    port.load(warmup=False)
    return port, ref


def pinned(engine, mode, texts):
    """The JAX engine's batch at one dispatch mode (False: one-graph, True: two-stage)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(engine), "two_stage_enabled", property(lambda self: mode))
        return engine.synthesize_batch(texts)


@pytest.mark.parametrize("mode", ["one_graph", "two_stage", "stream"])
def test_engine_matches_jax_engine(engines, mode):
    """TTSEngine serving NovaGAN from the JAX engine's checkpoint: its two-stage PCM
    equals the JAX engine's one-graph and two-stage PCM, and its streamed PCM the
    JAX engine's stream, within one int16 step. The stream is
    held against the JAX engine's stream: its context rule reads vocos_layers for
    either family, shorter than the generator's receptive field, so neither
    package's stream equals its one-shot audio here."""
    port, ref = engines
    if mode == "stream":
        text = "A sentence long enough to need several streaming vocoder windows to cover."
        ours = list(port.synthesize_stream(text))
        theirs = list(ref.synthesize_stream(text))
        assert len(ours) == len(theirs) > 2
        got, want = np.concatenate(ours), np.concatenate(theirs)
    else:
        got, want = port.synthesize_batch(TEXTS), pinned(ref, mode == "two_stage", TEXTS)
        assert [a.shape for a in got] == [b.shape for b in want]
        got, want = np.concatenate(got), np.concatenate(want)
    assert got.dtype == np.float32 and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, atol=1.01 * LSB16, rtol=0)


def test_engine_warmup_and_voice(engines):
    """warmup runs the batch and stream shapes with the HiFi-GAN vocoder, and a
    cloned voice (embed_voice, the plain mel on the CPU) matches the JAX engine's
    embedding within 1e-4."""
    port, ref = engines
    port.warmup()
    audio = (0.2 * np.sin(np.arange(36000) * 2 * np.pi * 180 / 24000)).astype(np.float32)
    np.testing.assert_allclose(port.embed_voice(audio, 24000), ref.embed_voice(audio, 24000), atol=1e-4, rtol=0)
