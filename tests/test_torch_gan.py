"""The port's adversarial (HiFi-GAN) phase vs the JAX package's, f32 on the CPU.

A small config: d_model 32 with 1+1 layers, a HiFi-GAN generator at initial width
32 with three upsamplers (8·8·4 = the 256-sample hop) and two MRF blocks (k 3/7,
dilations 1·3), the critics at disc_width 0.25. Both sides get one seeded tree
(the pipeline and the critics, made by the port's initializers and handed to JAX
as numpy) and the same numpy batch; the JAX steps run under its optax chain.
Tolerances are stated per test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.models import tts as jtts
from gonova_tts_tpu.train import checkpoint as jckpt
from gonova_tts_tpu.train import step as jstep
from gonova_tts_tpu_torch import cli
from gonova_tts_tpu_torch.config import Config, ModelConfig
from gonova_tts_tpu_torch.models import layers, params, tts, vocoder
from gonova_tts_tpu_torch.train import _jax_prng, loop, synth_corpus
from gonova_tts_tpu_torch.train import step as tstep

TINY = dict(
    d_model=32, n_heads=2, d_ff=64, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocoder_family="hifigan", upsample_initial_channel=32, upsample_rates=[8, 8, 4],
    upsample_kernels=[16, 16, 8], resblock_kernels=[3, 7], resblock_dilations=[[1, 3], [1, 3]],
    disc_width=0.25,
)
CFG = ModelConfig(**TINY, device="cpu")
JCFG = JModelConfig(**TINY)
SEG = tstep.GAN_SEGMENT_SAMPLES
# Frames of the batch: 32 frames = 8192 samples = one segment (no crop); 40 frames =
# 10240 samples, a crop of 8192 at one of 2049 offsets.
FRAMES = {"no_crop": 32, "crop": 40}
GAN_LR = 2e-4  # the phase's default learning rate


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


def numpy_tree(module):
    return params.unflatten({k.replace(".", "/"): v.numpy() for k, v in module.state_dict().items()})


@pytest.fixture(scope="module")
def jtrees():
    """(pipeline tree, critics tree) with numpy leaves, in the JAX layout."""
    pipe = numpy_tree(tts.TTS(CFG, torch.Generator().manual_seed(5)))
    critics = vocoder.discriminators_init(
        torch.Generator().manual_seed(101), torch.Generator().manual_seed(102), CFG.disc_width
    )
    return pipe, numpy_tree(critics)


def np_batch(frames: int, seed: int = 3):
    """Two utterances, the second 7 frames short and padded as the dataset pads:
    the log-mel at the log(1e-5) silence floor, the audio with zeros."""
    rng = np.random.default_rng(seed)
    b, hop = 2, CFG.hop_length
    fm = (np.arange(frames)[None] < np.array([[frames], [frames - 7]])).astype(np.float32)
    mel = np.where(fm[..., None] > 0, rng.normal(size=(b, frames, CFG.n_mels)) - 4.0, np.log(1e-5))
    audio = 0.1 * rng.normal(size=(b, frames * hop)) * np.repeat(fm, hop, axis=1)
    return {"mel": mel.astype(np.float32), "audio": audio.astype(np.float32), "frame_mask": fm}


def port_states(jtrees, lr):
    pipe, critics = jtrees
    model = params.from_numpy_tree(pipe, CFG, device="cpu")
    opt = tstep.make_optimizer(lr=lr, warmup=1, decay_steps=10)
    gen = tstep.init_state(layers.group(vocoder=model.vocoder), opt)
    disc = tstep.init_state(params.discriminators_from_numpy(critics, CFG.disc_width, device="cpu"), opt)
    return gen, disc


def jax_states(jtrees, lr):
    pipe, critics = jtrees
    opt = jstep.make_optimizer(lr=lr, warmup=1, decay_steps=10)
    gen = jstep.init_state(jax.tree_util.tree_map(jnp.asarray, {"vocoder": pipe["vocoder"]}), opt)
    disc = jstep.init_state(jax.tree_util.tree_map(jnp.asarray, critics), opt)
    return gen, disc, opt


def flat(tree):
    return {k.replace("/", "."): np.asarray(v) for k, v in params.flatten(tree).items()}


# ---------------------------------------------------------------- the crop offset


@pytest.mark.parametrize("span", [2049, 122881, 65537])
def test_crop_offsets_match_jax(span):
    """`randint(fold_in(PRNGKey(77), step), (), 0, span)` for steps 0..255, exactly:
    2049 is the tests' crop, 122881 the demo corpus' (131072 - 8192 + 1), 65537 the
    first span above 2^16 (where JAX's multiplier wraps to 0)."""
    draw = jax.jit(jax.vmap(
        lambda s: jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(77), s), (), 0, span)
    ))
    want = np.asarray(draw(jnp.arange(256)))
    got = np.array([_jax_prng.crop_offset(s, span) for s in range(256)])
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 200  # the draw varies with the step


def test_crop_pair_slices_both_signals():
    real = torch.arange(2 * 10240, dtype=torch.float32).reshape(2, 10240)
    r, f = tstep._crop_pair(real, -real, 3)
    off = _jax_prng.crop_offset(3, 10240 - SEG + 1)
    torch.testing.assert_close(r, real[:, off : off + SEG], rtol=0, atol=0)
    torch.testing.assert_close(f, -r, rtol=0, atol=0)
    short = real[:, :SEG]
    assert tstep._crop_pair(short, short, 3)[0] is short


# ---------------------------------------------------------------- losses and steps


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_three_gan_pairs_match_jax(jtrees, case):
    """Three d/g pairs of make_gan_steps against the JAX package's jitted pair, at
    the phase's learning rate (optax: clip, AdamW, warmup 1, so pairs 2 and 3 move
    the weights), with the crop off and firing.

    `_gan_loss_fns` at step 0 on the initial weights equals the first pair's JAX
    losses, and the d, adv, fm and mel of the first two pairs agree, rtol 1e-5 (the
    first update's learning rate is schedule(0) = 0, so both pairs see the same
    weights); the third pair's within 1e-4, after an update that moved a few
    elements apart by a flip (below). After three pairs each network's parameter
    vector is within 1e-4 of JAX's in relative L2 (measured: 6e-7 to 3.3e-5), and
    every element within Adam's own bound, 2 * lr per update. Two things flip at
    rounding level in any two f32 implementations: the sign of a near-zero
    gradient, which Adam's normalized step (about lr * sign) follows; and the side
    of a leaky ReLU's kink for an activation at ~1e-8 (one element of the crop
    case's batch: 2.4e-8 in JAX, -2.3e-7 here, which moves that block's gradient by
    about 1%)."""
    nb = np_batch(FRAMES[case], seed=11)
    jgen, jdisc, jopt = jax_states(jtrees, GAN_LR)
    jd_step, jg_step = jstep.make_gan_steps(JCFG, jopt, jopt)
    gen, disc = port_states(jtrees, GAN_LR)
    d_step, g_step = tstep.make_gan_steps(CFG)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.as_tensor(v) for k, v in nb.items()}
    d_loss_fn, g_loss_fn = tstep._gan_loss_fns(CFG)
    with torch.no_grad():
        d0 = float(d_loss_fn(disc.params, gen.params, tb["mel"], tb["audio"], 0))
        g0 = {k: float(v) for k, v in g_loss_fn(gen.params, disc.params, tb["mel"], tb["audio"], tb["frame_mask"], 0)[1].items()}
    for i in range(3):
        jdisc, jd = jd_step(jdisc, jgen.params, jb["mel"], jb["audio"])
        jgen, jm = jg_step(jgen, jdisc.params, jb["mel"], jb["audio"], jb["frame_mask"])
        disc, dl = d_step(disc, gen.params, tb["mel"], tb["audio"])
        gen, m = g_step(gen, disc.params, tb["mel"], tb["audio"], tb["frame_mask"])
        if i == 0:
            np.testing.assert_allclose(d0, float(jd), rtol=1e-5)
            for k in jm:
                np.testing.assert_allclose(g0[k], float(jm[k]), rtol=1e-5, err_msg=k)
        rtol = 1e-5 if i < 2 else 1e-4
        np.testing.assert_allclose(float(dl), float(jd), rtol=rtol, err_msg=f"pair {i} d")
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, err_msg=f"pair {i} {k}")
    assert gen.step == disc.step == 3
    for ours, ref in ((gen.params, jgen.params), (disc.params, jdisc.params)):
        got = {k: v.detach().numpy() for k, v in ours.named_parameters()}
        want = flat(ref)
        assert sorted(got) == sorted(want)
        diff = np.concatenate([(got[k] - w).ravel() for k, w in want.items()])
        norm = np.linalg.norm(np.concatenate([w.ravel() for w in want.values()]))
        assert np.linalg.norm(diff) <= 1e-4 * norm
        assert np.abs(diff).max() <= 2 * GAN_LR * 2


def test_resident_gan_chunk_equals_per_step_pairs(jtrees):
    """One make_resident_gan_chunk call of 2 pairs from start 1 over two batches
    equals two make_gan_steps pairs over batches 1 then 0 (the same code on the
    same inputs: bit-equal), EMA and chunk-mean metrics included."""
    batches = [np_batch(FRAMES["crop"], seed=s) for s in (1, 2)]
    gen_a, disc_a = port_states(jtrees, GAN_LR)
    run, corpus = tstep.make_resident_gan_chunk(CFG, batches, chunk=2, ema_decay=0.9, device="cpu")
    ema_a = tstep.ema_init_zeros(gen_a.params)
    gen_a, disc_a, ema_a, means = run(gen_a, disc_a, ema_a, 1, corpus)
    gen_b, disc_b = port_states(jtrees, GAN_LR)
    d_step, g_step = tstep.make_gan_steps(CFG)
    ema_b = tstep.ema_init_zeros(gen_b.params)
    seen = []
    for i in (1, 0):
        b = {k: torch.as_tensor(v) for k, v in batches[i].items()}
        disc_b, dl = d_step(disc_b, gen_b.params, b["mel"], b["audio"])
        gen_b, m = g_step(gen_b, disc_b.params, b["mel"], b["audio"], b["frame_mask"])
        ema_b = tstep.ema_update(ema_b, gen_b.params, 0.9)
        seen.append({"d": dl, **m})
    assert gen_a.step == disc_a.step == 2
    for a, b in ((gen_a.params, gen_b.params), (disc_a.params, disc_b.params)):
        for (k, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    for k in ema_a:
        torch.testing.assert_close(ema_a[k], ema_b[k], rtol=0, atol=0)
    for k in means:
        torch.testing.assert_close(means[k], (seen[0][k] + seen[1][k]) / 2, rtol=1e-6, atol=0)


def test_gan_steps_refuse_kernels():
    with pytest.raises(ValueError, match="no backward"):
        tstep.make_gan_steps(CFG.model_copy(update={"acoustic_pallas": True}))


# ---------------------------------------------------------------- the loop, the CLI


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("gan_corpus")
    synth_corpus.generate_corpus(
        str(root), sentences=synth_corpus.DEFAULT_SENTENCES[:2], speakers=synth_corpus.DEFAULT_SPEAKERS[:2],
        variable=True, holdout=1,
    )
    return os.path.join(str(root), "manifest_train.txt")


def tiny_config():
    cfg = Config()
    cfg.model = ModelConfig(**TINY, device="cpu")
    return cfg


def test_train_gan_phase_resident(corpus, tmp_path):
    """Resident: joint 2 steps + 3 GAN pairs, rounded to whole chunks of 2: gan_*
    metrics finite, the history's GAN lines, the ema_pre_gan checkpoint at `steps`
    and the final one at `steps + n_gan`, the final vocoder moved from the
    baseline's and nothing else, and the final file read by the JAX package as a
    HiFi-GAN pipeline without the aligner, whose vocoder it runs."""
    hist = tmp_path / "h.jsonl"
    ck = tmp_path / "ck"
    out = loop.train(
        tiny_config(), manifest=corpus, resident=True, chunk=2, steps=2, warmup=1, batch_size=2,
        checkpoint_dir=str(ck), history_path=str(hist), gan=True, gan_steps=3, device="cpu",
    )
    assert {"gan_d", "gan_adv", "gan_fm", "gan_mel", "total"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())
    lines = [json.loads(x) for x in hist.read_text().splitlines()]
    gan_lines = [x for x in lines if x.get("phase") == "gan"]
    assert [x["step"] for x in gan_lines] == [2, 4]
    assert all(set(x) == {"phase", "step", "d", "adv", "fm", "mel"} for x in gan_lines)
    assert sorted(os.listdir(ck)) == ["step_00000002.npz", "step_00000006.npz"]
    base = jckpt.restore_params_npz(str(ck / "step_00000002.npz"))
    final = jckpt.restore_params_npz(str(ck / "step_00000006.npz"))
    assert set(final) == {"acoustic", "vocoder", "speaker"}
    mel = jnp.asarray(np_batch(4)["mel"][:1])
    wav = np.asarray(jtts.vocode(jax.tree_util.tree_map(jnp.asarray, final), mel, JCFG))
    assert wav.shape == (1, 4 * CFG.hop_length) and np.isfinite(wav).all()
    fb, ff = params.flatten(base), params.flatten(final)
    assert max(np.abs(ff[k] - fb[k]).max() for k in ff if k.startswith("vocoder/")) > 0
    for k in ff:
        if not k.startswith("vocoder/"):
            np.testing.assert_array_equal(ff[k], fb[k], err_msg=k)


def test_train_gan_needs_a_manifest():
    with pytest.raises(ValueError, match="manifest"):
        loop.train(tiny_config(), steps=1, gan=True, device="cpu")


def test_cli_train_gan(corpus, tmp_path, capsys):
    """`train --gan` runs the per-step path end to end (joint 2 steps, then 2 GAN
    pairs, the default count = the joint steps): finite metrics and checkpoints at
    steps 2 and 4."""
    cfg_file = tmp_path / "c.yaml"
    cfg_file.write_text(json.dumps({"model": {**TINY, "device": "cpu"}}))
    args = ["train", "--manifest", corpus, "--steps", "2", "--batch-size", "2", "--warmup", "1",
            "--config", str(cfg_file), "--gan", "--checkpoint-dir", str(tmp_path / "ck")]
    assert cli.main(args) == 0
    out = json.loads(capsys.readouterr().out)
    assert {"gan_d", "gan_adv", "gan_fm", "gan_mel"} <= set(out) and all(np.isfinite(list(out.values())))
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002.npz", "step_00000004.npz"]
