"""The port's training path vs the JAX package's, f32 on the CPU, at a small config
(d_model 32, 1+1 layers, Vocos 32 wide with 1 block): stft/istft, losses, pitch,
the formant corpus, the data pipeline, the loss function, gradients, optimizer,
EMA, npz checkpoints across packages, the loop and the CLI; and the repairs this
slice needed (engine.data_parallel, the kernel-weight memo after in-place updates).

Both sides get one seeded JAX parameter tree (with the aligner) loaded into the
port, and the same numpy batch. Tolerances are stated per test.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gonova_tts_tpu.audio import pitch as jpitch
from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.models import tts as jtts
from gonova_tts_tpu.train import checkpoint as jckpt
from gonova_tts_tpu.train import data as jdata
from gonova_tts_tpu.train import losses as jlosses
from gonova_tts_tpu.train import step as jstep
from gonova_tts_tpu.train import synth_corpus as jcorpus
from gonova_tts_tpu_torch import cli
from gonova_tts_tpu_torch.audio import pitch, stft
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine
from gonova_tts_tpu_torch.models import acoustic, params, vocos
from gonova_tts_tpu_torch.train import checkpoint, data, losses, loop, synth_corpus
from gonova_tts_tpu_torch.train import step as tstep

# The JAX package's audio/__init__ exports a function `stft` that shadows the module.
jstft = importlib.import_module("gonova_tts_tpu.audio.stft")

TINY = dict(
    d_model=32, n_heads=2, d_ff=64, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocos_dim=32, vocos_ff=64, vocos_layers=1,
)
CFG = ModelConfig(**TINY, device="cpu")
JCFG = JModelConfig(**TINY)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jtree():
    """One seeded JAX tree with the aligner (numpy leaves)."""
    init = jax.jit(lambda k: jtts.init(k, JCFG, with_aligner=True))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(7)))


def port_model(jtree):
    return params.from_numpy_tree(jtree, CFG, device="cpu", with_aligner=True)


def flat_jax(tree):
    """'.'-joined names → numpy, the port's parameter names."""
    return {k.replace("/", "."): np.asarray(v) for k, v in params.flatten(tree).items()}


def np_batch(learn_alignment: bool, seed: int = 3):
    """A supervised batch at the small config: ragged token and frame lengths,
    reference-clip mels (the speaker embedding is computed in the step)."""
    rng = np.random.default_rng(seed)
    b, l = 2, 8
    t = l * CFG.max_frames_per_token
    tl, fl = np.array([8, 6]), np.array([52, 36])
    tm = (np.arange(l)[None] < tl[:, None]).astype(np.float32)
    fm = (np.arange(t)[None] < fl[:, None]).astype(np.float32)
    dur = np.zeros((b, l), np.int32)
    for i in range(b):
        dur[i, : tl[i]] = fl[i] // tl[i]
        dur[i, : fl[i] - dur[i].sum()] += 1
    batch = {
        "tokens": (rng.integers(1, 60, (b, l)) * tm).astype(np.int32),
        "token_mask": tm,
        "speaker": rng.normal(size=(b, CFG.speaker_dim)).astype(np.float32),
        "exaggeration": np.full((b,), 0.5, np.float32),
        "durations": dur,
        "pitch": (rng.normal(size=(b, l)) * tm).astype(np.float32),
        "mel": (rng.normal(size=(b, t, CFG.n_mels)) - 4.0).astype(np.float32) * fm[..., None],
        "frame_mask": fm,
        "audio": (0.1 * rng.normal(size=(b, t * CFG.hop_length))).astype(np.float32),
        "ref_mel": (rng.normal(size=(b, 40, CFG.n_mels)) - 4.0).astype(np.float32),
        "ref_mask": (np.arange(40)[None] < np.array([[40], [25]])).astype(np.float32),
    }
    if learn_alignment:
        batch["pitch_frames"] = (rng.normal(size=(b, t)) * fm).astype(np.float32)
        batch["align_mel"] = (rng.normal(size=(b, t, CFG.n_mels)) - 4.0).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------- repairs


def test_stft_and_istft_match_jax():
    """Complex STFT, istft of a complex tensor and of a (real, imag) tuple, with and
    without `length`: rtol 1e-5, atol 1e-5 of the largest magnitude (f32 DFT sums of
    1024 terms in another order)."""
    x = np.random.default_rng(0).normal(size=(2, 4096)).astype(np.float32)
    ref = np.asarray(jstft.stft(jnp.asarray(x)))
    ours = stft.stft(torch.as_tensor(x))
    assert ours.is_complex() and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    for length in (None, 4000):
        want = np.asarray(jstft.istft(jnp.asarray(ref), length=length))
        got_c = stft.istft(torch.as_tensor(ref.copy()), length=length).numpy()
        got_t = stft.istft((torch.as_tensor(ref.real.copy()), torch.as_tensor(ref.imag.copy())), length=length).numpy()
        assert got_c.shape == want.shape
        np.testing.assert_allclose(got_c, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        np.testing.assert_array_equal(got_c, got_t)


def test_istft_inverts_stft():
    """istft(stft(x)) == x within 1e-5 (NOLA overlap-add of the analysis window)."""
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 2048)).astype(np.float32))
    for n_fft, hop in ((1024, 256), (512, 128)):
        y = stft.istft(stft.stft(x, n_fft, hop, n_fft), n_fft, hop, n_fft, length=x.shape[-1])
        assert float((y - x).abs().max()) < 1e-5


@pytest.mark.parametrize("n", [0, 1, 2])
def test_engine_data_parallel(n):
    """0 (every device: one on the CPU) and 1 serve; 2 raises the JAX engine's
    message (engine/multi.py)."""
    cfg = Config()
    cfg.model = ModelConfig(**TINY, device="cpu", compute_dtype="float32")
    cfg.engine = EngineConfig(data_parallel=n)
    eng = TTSEngine(cfg, device="cpu")
    if n == 2:
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            eng.load(warmup=False)
    else:
        eng.load(warmup=False)
        assert eng.data_parallel == 1 and eng.is_loaded


def test_kernel_weight_memo_follows_in_place_updates(jtree):
    """The kernel path (on the CPU: the wrappers' plain versions on the packed,
    memoized weights) after two training steps, which update the parameters in
    place, equals the plain layers on the trained parameters (atol 1e-6): the
    train step drops the memo, so it is rebuilt, not stale."""
    model = port_model(jtree)
    on = CFG.model_copy(update={"acoustic_pallas": True, "vocos_pallas": True})
    b = to_torch(np_batch(False))
    args = (b["tokens"], b["token_mask"], b["speaker"], b["exaggeration"])

    def both(cfg):
        with torch.inference_mode():
            ac = acoustic.forward(model.acoustic, *args, cfg, durations=b["durations"])
            return ac["mel"], vocos.forward(model.vocoder, b["mel"], cfg)

    mel_0, _ = both(on)  # builds the memo
    assert any("_derived" in m.__dict__ for m in model.modules())
    state = tstep.init_state(model, tstep.make_optimizer(lr=1e-2, warmup=1, decay_steps=10))
    train = tstep.make_train_step(CFG)
    for _ in range(2):  # the first update has learning rate 0
        state, _ = train(state, b)
    (mel_k, wav_k), (mel_p, wav_p) = both(on), both(CFG)
    assert np.abs(mel_p.numpy() - mel_0.numpy()).max() > 1e-3  # the steps moved the output
    np.testing.assert_allclose(mel_k.numpy(), mel_p.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(wav_k.numpy(), wav_p.numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- losses, pitch


def _loss_inputs(rng):
    pred = rng.normal(size=(2, 12, 5)).astype(np.float32)
    target = rng.normal(size=(2, 12, 5)).astype(np.float32)
    mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.float32)
    outs = lambda: [(rng.normal(size=(2, 9)).astype(np.float32),  # noqa: E731
                     [rng.normal(size=(2, 4, 3)).astype(np.float32) for _ in range(3)]) for _ in range(2)]
    return pred, target, mask, outs(), outs()


LOSS_CASES = {
    "masked_l1": lambda m, a: m.masked_l1(a["pred"], a["target"], a["mask"]),
    "masked_mse": lambda m, a: m.masked_mse(a["pred"][..., 0], a["target"][..., 0], a["mask"]),
    "duration_loss": lambda m, a: m.duration_loss(a["pred"][..., 0], a["dur"], a["mask"]),
    "acoustic_loss": lambda m, a: m.acoustic_loss(
        {"mel": a["pred"], "frame_mask": a["mask"], "log_durations": a["pred"][..., 1], "pitch": a["pred"][..., 2]},
        a["target"], a["dur"], a["target"][..., 0], a["mask"])[0],
    "multi_resolution_stft_loss": lambda m, a: m.multi_resolution_stft_loss(a["wav"], a["wav_t"]),
    "mel_reconstruction_loss": lambda m, a: m.mel_reconstruction_loss(a["wav"], a["mel_t"], a["fmask"], a["cfg"]),
    "lsgan_discriminator_loss": lambda m, a: m.lsgan_discriminator_loss(a["real"], a["fake"]),
    "lsgan_generator_loss": lambda m, a: m.lsgan_generator_loss(a["fake"]),
    "feature_matching_loss": lambda m, a: m.feature_matching_loss(a["real"], a["fake"]),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    """All nine loss functions on the same arrays, rtol 1e-5."""
    rng = np.random.default_rng(4)
    pred, target, mask, real, fake = _loss_inputs(rng)
    wav = (0.1 * rng.normal(size=(2, 4096))).astype(np.float32)
    arrays = {
        "pred": pred, "target": target, "mask": mask, "real": real, "fake": fake,
        "dur": rng.integers(0, 8, (2, 12)).astype(np.int32), "wav": wav,
        "wav_t": (wav + 0.05 * rng.normal(size=wav.shape)).astype(np.float32),
        "mel_t": (rng.normal(size=(2, 16, 80)) - 4.0).astype(np.float32),
        "fmask": (np.arange(16)[None] < np.array([[16], [10]])).astype(np.float32),
    }

    def conv(fn):
        def go(x):
            if isinstance(x, list):
                return [go(v) for v in x]
            if isinstance(x, tuple):
                return tuple(go(v) for v in x)
            return fn(x)
        return {k: go(v) for k, v in arrays.items()}

    ours = LOSS_CASES[name](losses, {**conv(torch.as_tensor), "cfg": CFG})
    ref = jax.jit(lambda a: LOSS_CASES[name](jlosses, {**a, "cfg": JCFG}))(conv(jnp.asarray))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def test_pitch_matches_jax_exactly():
    rng = np.random.default_rng(2)
    t = np.arange(24000) / 24000.0
    audio = (0.3 * np.sin(2 * np.pi * 150 * t) + 0.01 * rng.normal(size=t.shape)).astype(np.float32)
    audio[8000:12000] = 0.0
    f0 = pitch.estimate_f0(audio)
    np.testing.assert_array_equal(f0, jpitch.estimate_f0(audio))
    np.testing.assert_array_equal(pitch.f0_to_feature(f0), jpitch.f0_to_feature(f0))
    assert (f0 > 0).any() and (f0 == 0).any()


# ---------------------------------------------------------------- corpus, data


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same 2-speaker x 2-sentence variable-duration corpus from both packages."""
    root = tmp_path_factory.mktemp("corpus")
    kw = dict(sentences=synth_corpus.DEFAULT_SENTENCES[:2], speakers=synth_corpus.DEFAULT_SPEAKERS[:2],
              variable=True, holdout=1)
    ours = synth_corpus.generate_corpus(str(root / "port"), **kw)
    ref = jcorpus.generate_corpus(str(root / "jax"), **kw)
    return root, ours, ref


def test_synth_corpus_is_byte_identical(corpora):
    root, ours, ref = corpora
    read = lambda p, d: open(p).read().replace(str(root / d), "DIR")  # noqa: E731
    assert read(ours, "port") == read(ref, "jax")
    for name in ("manifest_train.txt", "manifest_heldout.txt", "corpus_meta.json"):
        assert read(root / "port" / name, "port") == read(root / "jax" / name, "jax")
    wavs = sorted(f for f in os.listdir(root / "jax") if f.endswith(".wav"))
    assert len(wavs) == 6  # 2 speakers x (2 sentences + 1 reference clip)
    for f in wavs:
        assert (root / "port" / f).read_bytes() == (root / "jax" / f).read_bytes(), f


LOG_FEATURES = ("mel", "align_mel", "ref_mel")


def assert_batches_close(got, want):
    """Integer arrays equal; float arrays within atol 1e-5, the log-mel features
    compared as mel energies (exp): near the log floor (mel ~1e-5, the corpus'
    dithered silence) the log turns f32 rounding of the DFT sums into up to 0.013
    (the JAX side is that far from a float64 reference there, the port 0.0013)."""
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        if np.issubdtype(got[k].dtype, np.integer):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k in LOG_FEATURES:
            np.testing.assert_allclose(np.exp(got[k]), np.exp(want[k]), atol=1e-5, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_manifest_dataset_epoch_matches_jax(corpora):
    """One epoch of batches (learned alignment, reference mels, a padded batch)."""
    root, ours, ref = corpora
    kw = dict(batch_size=3, token_buckets=(64,), seed=0, ref_mel=True, learn_alignment=True)
    got = list(data.ManifestDataset(ours, CFG, **kw).epoch(0))
    want = list(jdata.ManifestDataset(ref, JCFG, **kw).epoch(0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_batches_close(g, w)
        # The log-mel itself: within 2e-4 on all but the frames near the floor.
        assert (np.abs(g["mel"] - w["mel"]) > 2e-4).mean() < 0.05


def test_make_batch_uniform_durations_match_jax(corpora):
    """The duration-target path: uniform spread, per-token pitch means."""
    _, ours, ref = corpora
    e_ours = [data.prepare_example(e["wav"], e["text"], CFG) for e in data.load_manifest(ours)[:2]]
    e_ref = [jdata.prepare_example(e["wav"], e["text"], JCFG) for e in jdata.load_manifest(ref)[:2]]
    assert_batches_close(data.make_batch(e_ours, CFG), jdata.make_batch(e_ref, JCFG))
    np.testing.assert_array_equal(data._uniform_durations(5, 13, 8), jdata._uniform_durations(5, 13, 8))
    np.testing.assert_allclose(data.silence_mel(CFG), jdata.silence_mel(JCFG), atol=1e-5)


# ---------------------------------------------------------------- step


@jax.jit
def _jax_loss_plain(p, b, step):
    return jstep.tts_loss_fn(p, b, JCFG, jnp.float32, False, step)


@jax.jit
def _jax_vg_align(p, b, step):
    return jax.value_and_grad(jstep.tts_loss_fn, has_aux=True)(p, b, JCFG, jnp.float32, True, step)


def test_loss_parts_match_jax_with_duration_targets(jtree):
    """tts_loss_fn's parts with the batch's duration targets, rtol 1e-4."""
    nb = np_batch(False)
    _, ref = _jax_loss_plain(jtree, {k: jnp.asarray(v) for k, v in nb.items()}, jnp.asarray(5))
    with torch.no_grad():
        _, ours = tstep.tts_loss_fn(port_model(jtree), to_torch(nb), CFG, learn_alignment=False, align_step=5)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-4, err_msg=k)


def test_learned_alignment_loss_parts_and_first_step_grads_match_jax(jtree):
    """tts_loss_fn with the aligner learned in the step: parts rtol 1e-4 (so MAS
    gave both sides the same durations); every parameter's gradient rtol 1e-3 with
    atol 1e-6 of the largest |gradient| of the tree (a gradient that is zero in
    exact arithmetic, as the attention key bias's, is f32 noise on both sides)."""
    nb = np_batch(True)
    (_, ref_m), ref_g = _jax_vg_align(jtree, {k: jnp.asarray(v) for k, v in nb.items()}, jnp.asarray(5))
    model = port_model(jtree)
    model.requires_grad_(True)
    total, ours = tstep.tts_loss_fn(model, to_torch(nb), CFG, learn_alignment=True, align_step=5)
    total.backward()
    assert sorted(ours) == sorted(ref_m)
    for k in ref_m:
        np.testing.assert_allclose(float(ours[k].detach()), float(ref_m[k]), rtol=1e-4, err_msg=k)
    ref_flat = flat_jax(ref_g)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(ref_flat)
    g_max = max(float(np.abs(v).max()) for v in ref_flat.values())
    for k, want in ref_flat.items():
        got = named[k].grad
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6 * g_max, err_msg=k)


def test_schedule_matches_optax():
    """optax.warmup_cosine_decay_schedule at counts 0..30 (rtol 1e-6), and the
    learning rate AdamW actually holds after each update."""
    opt = tstep.make_optimizer(lr=3e-4, warmup=5, decay_steps=25)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 25, end_value=3e-4 * 0.05)
    ref = np.asarray(jax.jit(jax.vmap(sched))(jnp.arange(31)))
    np.testing.assert_allclose([opt.schedule(c) for c in range(31)], ref, rtol=1e-6, atol=1e-12)
    p = torch.nn.Parameter(torch.ones(3))
    state = opt.init([p])
    for c in range(7):
        np.testing.assert_allclose(state.adamw.param_groups[0]["lr"], ref[c], rtol=1e-6, atol=1e-12)
        p.grad = torch.ones(3)
        state.update()


def test_three_optimizer_steps_match_jax(jtree):
    """Three steps of the learned-alignment step with warmup 2 (lr 0, 5e-4, 1e-3);
    the JAX side is make_train_step's body (value_and_grad of tts_loss_fn at
    align_step = the step count, optimizer.update, apply_updates). Loss parts per
    step rtol 1e-4; parameters within 1e-5 on >= 99.9% of elements, and everywhere
    within 2 * lr * steps (Adam's bound where a near-zero gradient flips sign)."""
    lr, n = 1e-3, 3
    nb = np_batch(True, seed=9)
    jopt = jstep.make_optimizer(lr=lr, warmup=2, decay_steps=10)
    jstate = jstep.init_state(jax.tree_util.tree_map(jnp.asarray, jtree), jopt)

    @jax.jit
    def japply(grads, opt_state, p):
        updates, opt_state = jopt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    state = tstep.init_state(port_model(jtree), tstep.make_optimizer(lr=lr, warmup=2, decay_steps=10))
    train = tstep.make_train_step(CFG, learn_alignment=True)
    jb, tb = {k: jnp.asarray(v) for k, v in nb.items()}, to_torch(nb)
    jp, jo = jstate.params, jstate.opt_state
    for i in range(n):
        (_, ref_m), grads = _jax_vg_align(jp, jb, jnp.asarray(i))
        jp, jo = japply(grads, jo, jp)
        state, ours = train(state, tb)
        for k in ref_m:
            np.testing.assert_allclose(float(ours[k]), float(ref_m[k]), rtol=1e-4, err_msg=f"step {i} {k}")
    assert state.step == n
    got = {k: v.detach().numpy() for k, v in state.params.named_parameters()}
    diffs = np.concatenate([np.abs(got[k] - v).ravel() for k, v in flat_jax(jp).items()])
    assert (diffs <= 1e-5).mean() >= 0.999
    assert diffs.max() <= 2 * lr * n


def test_clip_is_optax_clip_by_global_norm():
    """Above the max norm every gradient is scaled by max_norm / ||g|| (no epsilon);
    below it they pass unchanged. Read through one update: the first Adam moment
    is (1 - b1) times the clipped gradient (rtol 1e-6)."""
    for scale in (10.0, 0.1):
        g = [np.full((3,), scale, np.float32), np.full((2, 2), -scale, np.float32)]
        ref = optax.clip_by_global_norm(1.0).update([jnp.asarray(x) for x in g], optax.EmptyState())[0]
        ps = [torch.nn.Parameter(torch.zeros(x.shape)) for x in g]
        state = tstep.Optimizer(lr=1e-3, weight_decay=0.0, warmup=0, decay_steps=10).init(ps)
        for p, x in zip(ps, g):
            p.grad = torch.as_tensor(x)
        state.update()
        for p, r in zip(ps, ref):
            m = state.adamw.state[p]["exp_avg"].numpy()
            np.testing.assert_allclose(m / 0.1, np.asarray(r), rtol=1e-6)


def test_ema_functions_match_jax(jtree):
    """ema_init, ema_init_zeros, ema_update (twice) and ema_debias, rtol 1e-6."""
    tree = {"acoustic": jtree["acoustic"]["spk_proj"], "aligner": {"temp": jtree["aligner"]["temp"]}}
    tree2 = jax.tree_util.tree_map(lambda x: x * 0.5 + 1.0, tree)
    named = lambda t: {k: torch.as_tensor(np.array(v)) for k, v in flat_jax(t).items()}  # noqa: E731
    for init, jinit in ((tstep.ema_init, jstep.ema_init), (tstep.ema_init_zeros, jstep.ema_init_zeros)):
        ours, ref = init(named(tree)), jinit(tree)
        for t in (tree2, tree):
            ours = tstep.ema_update(ours, named(t), 0.9)
            ref = jstep.ema_update(ref, t, 0.9)
        ours, ref = tstep.ema_debias(ours, 0.9, 2), flat_jax(jstep.ema_debias(ref, 0.9, 2))
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(ours[k].numpy(), ref[k], rtol=1e-6, atol=1e-7)


def test_synthetic_batch_shapes():
    b = tstep.synthetic_batch(CFG, batch=3, tokens=5, device="cpu")
    ref = jax.eval_shape(lambda: jstep.synthetic_batch(JCFG, batch=3, tokens=5))
    assert {k: tuple(v.shape) for k, v in b.items()} == {k: v.shape for k, v in ref.items()}
    assert {k: str(v.dtype).split(".")[-1] for k, v in b.items()} == {k: str(v.dtype) for k, v in ref.items()}
    torch.testing.assert_close(b["tokens"], tstep.synthetic_batch(CFG, batch=3, tokens=5, device="cpu")["tokens"])


def test_train_step_refuses_kernels():
    with pytest.raises(ValueError, match="no backward"):
        tstep.make_train_step(CFG.model_copy(update={"vocos_pallas": True}))


# ---------------------------------------------------------------- checkpoints


def test_port_npz_read_by_jax(jtree, tmp_path):
    """A port file (f16 compact and a f32 training step) read by the JAX package's
    restore_params_npz, load_meta and TTSEngine (model.model_path = the file)."""
    from gonova_tts_tpu.config import Config as JConfig
    from gonova_tts_tpu.engine import TTSEngine as JTTSEngine

    model = port_model(jtree)
    compact = checkpoint.save_params_npz(str(tmp_path / "m.npz"), model)
    step_file = checkpoint.save_params(str(tmp_path / "root"), loop._serve_params(tstep.ema_init(model)), step=7)
    assert step_file == str(tmp_path / "root" / "step_00000007.npz")
    for path, dt in ((compact, np.float16), (step_file, np.float32)):
        want = {k: v.astype(dt).astype(np.float32) for k, v in params.flatten(jtree).items()}
        if path == step_file:
            want = {k: v for k, v in want.items() if not k.startswith("aligner/")}
        got = params.flatten(jckpt.restore_params_npz(path))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert jckpt.load_meta(path) == checkpoint.load_meta(path) == {"format_version": 1, "stress": False}
    jcfg = JConfig()
    jcfg.model = JModelConfig(**TINY, model_path=step_file)
    eng = JTTSEngine(jcfg)
    eng.load(warmup=False)
    np.testing.assert_array_equal(
        np.asarray(eng.params["acoustic"]["mel_out"]["w"]), jtree["acoustic"]["mel_out"]["w"]
    )


def test_jax_npz_read_by_port(jtree, tmp_path):
    path = jckpt.save_params_npz(str(tmp_path / "j.npz"), jtree, dtype="float32")
    model, _ = params.load_checkpoint(path, CFG, device="cpu")
    want = flat_jax({k: v for k, v in jtree.items() if k != "aligner"})
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tree = checkpoint.restore_params(path)
    np.testing.assert_array_equal(tree["aligner"]["t_c1"]["w"], jtree["aligner"]["t_c1"]["w"])


def test_training_root_resolves_to_its_newest_step(jtree, tmp_path):
    """`load_checkpoint`, `restore_params` and `TTSEngine` take a training root's
    newest step_NNNNNNNN.npz."""
    root = str(tmp_path / "ckpt")
    old, new = port_model(jtree), port_model(jtree)
    with torch.no_grad():
        new.acoustic.mel_out.w.add_(1.0)
    checkpoint.save_params(root, old, step=50)
    checkpoint.save_params(root, new, step=200)
    assert checkpoint.latest_step_dir(root).endswith("step_00000200.npz")
    model, _ = params.load_checkpoint(root, CFG, device="cpu")
    torch.testing.assert_close(model.acoustic.mel_out.w, new.acoustic.mel_out.w.detach(), rtol=0, atol=0)
    np.testing.assert_array_equal(
        checkpoint.restore_params(root)["acoustic"]["mel_out"]["w"], new.acoustic.mel_out.w.detach().numpy()
    )
    cfg = Config()
    cfg.model = ModelConfig(**TINY, device="cpu", compute_dtype="float32", model_path=root)
    cfg.engine = EngineConfig()
    eng = TTSEngine(cfg, device="cpu")
    eng.load(warmup=False)
    torch.testing.assert_close(eng.params.acoustic.mel_out.w, new.acoustic.mel_out.w.detach(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no step_NNNNNNNN.npz"):
        params.load_checkpoint(str(tmp_path), CFG, device="cpu")


# ---------------------------------------------------------------- loop, CLI


def tiny_config():
    cfg = Config()
    cfg.model = ModelConfig(**TINY, device="cpu")
    return cfg


def test_train_on_synthetic_batches_writes_history_and_checkpoint(tmp_path):
    hist = tmp_path / "h.jsonl"
    out = loop.train(tiny_config(), steps=3, batch_size=2, warmup=2, checkpoint_dir=str(tmp_path / "ck"),
                     history_path=str(hist), device="cpu")
    assert {"total", "ac_mel", "stft", "voc_mel"} <= set(out) and all(np.isfinite(list(out.values())))
    lines = [json.loads(x) for x in hist.read_text().splitlines()]
    assert [x["step"] for x in lines] == [1] and np.isfinite(lines[0]["total"])
    assert os.listdir(tmp_path / "ck") == ["step_00000003.npz"]
    tree = checkpoint.restore_params(str(tmp_path / "ck"))
    assert "aligner" not in tree and np.isfinite(params.flatten(tree)["acoustic/mel_out/w"]).all()


def test_resident_training_on_the_corpus_learns_alignment(corpora, tmp_path):
    """The demo-corpus path at the small config: manifest without durations →
    learned alignment, resident chunks, EMA checkpoint without the aligner that
    TTSEngine serves."""
    _, ours, _ = corpora
    hist = tmp_path / "h.jsonl"
    manifest = os.path.join(os.path.dirname(ours), "manifest_train.txt")
    loop.train(tiny_config(), manifest=manifest, resident=True, chunk=2, steps=3, warmup=2, batch_size=2,
               checkpoint_dir=str(tmp_path / "ck"), history_path=str(hist), device="cpu")
    lines = [json.loads(x) for x in hist.read_text().splitlines()]
    assert [x["step"] for x in lines] == [2, 4]  # 3 steps rounded up to whole chunks
    assert {"align_fs", "align_bin", "dur_over_cap"} <= set(lines[0])
    assert all(np.isfinite(v) for x in lines for v in x.values())
    cfg = tiny_config()
    cfg.model.model_path = str(tmp_path / "ck")
    cfg.model.compute_dtype = "float32"
    eng = TTSEngine(cfg, device="cpu")
    eng.load(warmup=False)
    wav = eng.synthesize_batch(["Every token maps to one fixed sound."])[0]
    assert wav.size > 0 and np.isfinite(wav).all()


@pytest.mark.parametrize(
    "kw, error, match",
    [({"gan": True}, ValueError, "manifest"),
     ({"n_data": 2, "resident": True}, ValueError, "resident mode is single-device"),
     ({"n_model": 2, "resident": True}, ValueError, "resident mode is single-device")],
    ids=["gan", "n_data", "n_model"],
)
def test_train_refuses_what_is_not_ported(kw, error, match):
    """What the loop refuses, as the JAX loop does: the adversarial phase without a
    manifest corpus (before the joint phase), and sharding (ported:
    tests/test_torch_parallel.py) together with the single-device resident
    runner, with the JAX loop's message."""
    with pytest.raises(error, match=match):
        loop.train(tiny_config(), steps=1, device="cpu", **kw)


def test_cli_train(corpora, tmp_path, monkeypatch, capsys):
    """`train --demo-corpus DIR` trains resident on DIR's manifest_train.txt;
    with `--manifest` too it is refused."""
    _, ours, _ = corpora
    assert cli.main(["train", "--demo-corpus", "d", "--manifest", "m.txt"]) == 1
    assert "mutually exclusive" in capsys.readouterr().err
    seen = {}
    monkeypatch.setattr(loop, "train", lambda **kw: seen.update(kw) or {"total": 1.0})
    cfg_file = tmp_path / "c.yaml"
    cfg_file.write_text(json.dumps({"model": {**TINY, "device": "cpu"}}))
    corpus_dir = os.path.dirname(ours)
    assert cli.main(["train", "--demo-corpus", corpus_dir, "--steps", "4", "--config", str(cfg_file)]) == 0
    assert json.loads(capsys.readouterr().out) == {"total": 1.0}
    assert seen["manifest"] == os.path.join(corpus_dir, "manifest_train.txt")
    assert seen["resident"] and seen["steps"] == 4 and seen["chunk"] == 200
    assert seen["config"].model.d_model == 32 and seen["config"].model.device == "cpu"
