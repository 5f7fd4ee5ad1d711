"""The port's parallel package and sharded training vs the JAX package's, on the CPU.

The model is tests/test_parallel_train.py's tiny config (d_model 64, 2 heads, 1+1
layers, Vocos 128/256/2, vocab 64); the GAN pair runs a HiFi-GAN generator at
initial width 32 (rates 8·8·4) against the critics at disc_width 0.25. Inputs are
made from a numpy seed and the trees by the port's seeded initializers, handed to
JAX as numpy.

The sharded steps run in gloo process groups of spawned workers (one per mesh
position), on 2x2, 4x1 and 1x2 meshes; the JAX reference is the one-device
`jax.grad` of the same loss (XLA's sharded step computes that same global
function). The batch's masks differ between the shards' rows and the gradient
norm is above the clip's 1.0.

JAX is imported inside the tests: the spawned workers import this module.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gonova_tts_tpu_torch.config import Config, ModelConfig
from gonova_tts_tpu_torch.models import layers, params, tts, vocoder
from gonova_tts_tpu_torch.parallel import gather_params, launch, make_hybrid_mesh, make_mesh, param_spec
from gonova_tts_tpu_torch.parallel import mesh as pmesh
from gonova_tts_tpu_torch.train import loop
from gonova_tts_tpu_torch.train import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    upsample_initial_channel=32, vocos_dim=128, vocos_ff=256, vocos_layers=2, vocab_size=64,
)
GAN = dict(
    TINY, vocoder_family="hifigan", upsample_rates=[8, 8, 4], upsample_kernels=[16, 16, 8],
    resblock_kernels=[3, 7], resblock_dilations=[[1, 3], [1, 3]], disc_width=0.25,
)
CFG = ModelConfig(**TINY, device="cpu")
GCFG = ModelConfig(**GAN, device="cpu")
LR = 1e-3
MESHES = [(2, 2), (4, 1), (1, 2)]
GAN_FRAMES = 40  # 10240 samples: the GAN segment (8192) is cropped at a drawn offset


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


def numpy_tree(module):
    return params.unflatten({k.replace(".", "/"): v.numpy() for k, v in module.state_dict().items()})


def trees():
    """(joint pipeline with the aligner, HiFi-GAN pipeline, critics): numpy trees."""
    pipe = numpy_tree(tts.TTS(CFG, torch.Generator().manual_seed(5), with_aligner=True))
    gan_pipe = numpy_tree(tts.TTS(GCFG, torch.Generator().manual_seed(6)))
    critics = numpy_tree(vocoder.discriminators_init(
        torch.Generator().manual_seed(101), torch.Generator().manual_seed(102), GCFG.disc_width
    ))
    return pipe, gan_pipe, critics


def joint_batch(seed: int = 3):
    """Four utterances of ragged token and frame lengths (so every shard's masks
    differ), reference-clip mels, and the learned-alignment features."""
    rng = np.random.default_rng(seed)
    b, l = 4, 8
    t = l * CFG.max_frames_per_token
    tl, fl = np.array([8, 6, 7, 3]), np.array([52, 36, 60, 20])
    tm = (np.arange(l)[None] < tl[:, None]).astype(np.float32)
    fm = (np.arange(t)[None] < fl[:, None]).astype(np.float32)
    dur = np.zeros((b, l), np.int32)
    for i in range(b):
        dur[i, : tl[i]] = fl[i] // tl[i]
        dur[i, : fl[i] - dur[i].sum()] += 1
    return {
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
        "ref_mask": (np.arange(40)[None] < np.array([[40], [25], [33], [12]])).astype(np.float32),
        "pitch_frames": (rng.normal(size=(b, t)) * fm).astype(np.float32),
        "align_mel": (rng.normal(size=(b, t, CFG.n_mels)) - 4.0).astype(np.float32),
    }


def gan_batch(seed: int = 11):
    """Four utterances, padded as the dataset pads (log-mel floor, zero audio)."""
    rng = np.random.default_rng(seed)
    b, f, hop = 4, GAN_FRAMES, GCFG.hop_length
    fm = (np.arange(f)[None] < np.array([[f], [f - 7], [f - 3], [f - 12]])).astype(np.float32)
    mel = np.where(fm[..., None] > 0, rng.normal(size=(b, f, GCFG.n_mels)) - 4.0, np.log(1e-5))
    audio = 0.1 * rng.normal(size=(b, f * hop)) * np.repeat(fm, hop, axis=1)
    return {"mel": mel.astype(np.float32), "audio": audio.astype(np.float32), "frame_mask": fm}


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def flat(tree):
    return {k.replace("/", "."): np.asarray(v) for k, v in params.flatten(tree).items()}


# ---------------------------------------------------------------- sharding rules


def _leaf_paths():
    """Every parameter path of the TTS tree (Vocos, with the aligner), of the
    HiFi-GAN tree and of the critics, '/'-joined."""
    g = torch.Generator().manual_seed(0)
    models = {
        "vocos": tts.TTS(CFG, g, with_aligner=True),
        "hifigan": tts.TTS(GCFG, g),
        "critics": vocoder.discriminators_init(g, g, GCFG.disc_width),
    }
    return {name: [k.replace(".", "/") for k, _ in m.named_parameters()] for name, m in models.items()}, models


PATHS, MODELS = _leaf_paths()
ALL_PATHS = sorted({p for ps in PATHS.values() for p in ps})


def jax_shapes(name):
    """The JAX package's tree for one of MODELS, as shapes (no compute)."""
    import jax

    from gonova_tts_tpu.config import ModelConfig as JModelConfig
    from gonova_tts_tpu.models import tts as jtts
    from gonova_tts_tpu.models import vocoder as jvoc

    key = jax.random.PRNGKey(0)
    if name == "critics":
        w = GCFG.disc_width
        return jax.eval_shape(lambda k: {"mpd": jvoc.mpd_init(k, width=w), "msd": jvoc.msd_init(k, width=w)}, key)
    cfg = JModelConfig(**(TINY if name == "vocos" else GAN))
    return jax.eval_shape(lambda k: jtts.init(k, cfg, with_aligner=name == "vocos"), key)


@pytest.mark.parametrize("name", sorted(PATHS))
def test_leaf_paths_are_jaxs(name):
    """The port's parameter paths are the JAX tree's leaf paths, tree by tree."""
    from gonova_tts_tpu_torch.models.params import flatten

    assert sorted(PATHS[name]) == sorted(flatten(jax_shapes(name)))


@pytest.mark.parametrize("path", ALL_PATHS)
def test_param_spec_matches_jax(path):
    from gonova_tts_tpu.parallel import param_spec as jax_param_spec

    assert param_spec(path) == tuple(jax_param_spec(path))


@pytest.mark.parametrize("n_model", [2, 3])
@pytest.mark.parametrize("name", sorted(PATHS))
def test_fallback_leaves_match_jax(name, n_model):
    """The leaves that fall back to replicated because the 'model' axis does not
    divide them are JAX's, at n_model 2 and 3 (conftest's 8 CPU devices)."""
    import jax

    from gonova_tts_tpu.parallel import make_mesh as jmake_mesh
    from gonova_tts_tpu.parallel import param_shardings as jparam_shardings
    from gonova_tts_tpu.parallel import param_spec as jparam_spec
    from gonova_tts_tpu.parallel.mesh import _path_str

    jsh = jparam_shardings(jax_shapes(name), jmake_mesh(n_data=1, n_model=n_model))
    leaves = {_path_str(kp): tuple(sh.spec) for kp, sh in jax.tree_util.tree_flatten_with_path(jsh)[0]}
    want = {k for k, spec in leaves.items() if spec == () and "model" in tuple(jparam_spec(k))}
    ours = {k.replace(".", "/"): spec for k, spec in pmesh.param_shardings(MODELS[name], {"data": 1, "model": n_model}).items()}
    assert {k for k, spec in ours.items() if spec == () and "model" in param_spec(k)} == want
    assert {k for k, spec in ours.items() if spec} == {k for k, spec in leaves.items() if spec}


# ---------------------------------------------------------------- mesh helpers


def test_make_mesh_errors():
    devs = [pmesh.Member(r, 0) for r in range(8)]
    with pytest.raises(ValueError, match="mesh 5x2 exceeds 8 devices"):
        make_mesh(n_data=5, n_model=2, devices=devs)
    with pytest.raises(ValueError, match="8 devices not divisible by model axis 3"):
        make_mesh(n_model=3, devices=devs)
    with pytest.raises(ValueError, match="must cover the process group"):
        make_mesh(n_data=4, n_model=2, devices=devs)  # valid shape, no process group here


def test_hybrid_mesh_errors():
    """'model' must stay inside one host; hosts must hold equal shares."""
    four_hosts = [pmesh.Member(r, r // 2) for r in range(8)]
    with pytest.raises(ValueError, match="inside one host"):
        make_hybrid_mesh(n_model=4, devices=four_hosts)
    uneven = [pmesh.Member(r, 0 if r < 4 else 1) for r in range(7)]
    with pytest.raises(ValueError, match="uneven across 2 hosts"):
        make_hybrid_mesh(n_model=1, devices=uneven)


def test_init_distributed_noop_without_env(monkeypatch):
    monkeypatch.delenv("TTS_COORDINATOR", raising=False)
    assert pmesh.init_distributed() is False


def test_resident_refuses_sharding():
    """JAX's rule and message: the resident runner is single-device."""
    for kw in ({"n_data": 2}, {"n_model": 2}):
        with pytest.raises(ValueError, match="resident mode is single-device"):
            loop.train(_config(), steps=1, resident=True, device="cpu", **kw)


# ---------------------------------------------------------------- sharded steps vs JAX


def _gather_named(named, dims):
    return {k: v.detach().numpy() for k, v in gather_params(named, dims).items()}


def _spy(state, seen, key):
    """Record each parameter's gradient (after the 'data' sum, before the clip) and
    the clip's global norm, then take the update as usual."""
    orig = state.opt_state.apply
    names = [k for k, _ in state.params.named_parameters()]

    def apply():
        grads = [p.grad.clone() for p in state.opt_state.params]
        seen[key] = (dict(zip(names, grads)), float(state.opt_state.grad_norm(grads)))
        orig()

    state.opt_state.apply = apply


def _adam_mu(state):
    return {k: state.opt_state.adamw.state[p]["exp_avg"] for k, p in state.params.named_parameters()}


def _steps_on_mesh(n_data, n_model, pipe, gan_pipe, critics, batch, gb):
    """One rank: a sharded joint step (learned alignment) and a sharded GAN d/g
    pair. Returns, gathered over 'model', every gradient before the clip, the clip
    norm, the metrics, and parameters and first Adam moments after the update."""
    mesh = make_mesh(n_data, n_model)
    opt = tstep.make_optimizer(lr=LR, warmup=0, decay_steps=10)
    state = tstep.init_state(params.from_numpy_tree(pipe, CFG, device="cpu", with_aligner=True), opt)
    tb = to_torch(batch)
    step, st = tstep.make_sharded_train_step(CFG, opt, mesh, state, tb, learn_alignment=True)
    seen = {}
    _spy(st, seen, "joint")
    st, metrics = step(st, tb)

    model = params.from_numpy_tree(gan_pipe, GCFG, device="cpu")
    gen = tstep.init_state(layers.group(vocoder=model.vocoder), opt)
    disc = tstep.init_state(params.discriminators_from_numpy(critics, GCFG.disc_width, device="cpu"), opt)
    d_step, g_step, gen, disc = tstep.make_sharded_gan_steps(GCFG, opt, opt, mesh, gen, disc)
    _spy(disc, seen, "d")
    _spy(gen, seen, "g")
    t = to_torch(gb)
    disc, d_loss = d_step(disc, gen.params, t["mel"], t["audio"])
    gen, g_metrics = g_step(gen, disc.params, t["mel"], t["audio"], t["frame_mask"])

    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "d_loss": float(d_loss),
           "g_metrics": {k: float(v) for k, v in g_metrics.items()}}
    for key, s in (("joint", st), ("d", disc), ("g", gen)):
        dims = pmesh.split_dims(s.params)
        out[key] = {
            "grads": _gather_named(seen[key][0], dims), "norm": seen[key][1], "sharded": sorted(dims),
            "params": _gather_named(dict(s.params.named_parameters()), dims),
            "mu": _gather_named(_adam_mu(s), dims),
        }
    return out if torch.distributed.get_rank() == 0 else None


def _steps_on_meshes(store_dir, pipe, gan_pipe, critics, batch, gb):
    """Every mesh of MESHES in turn, in one set of workers: a new process group for
    each (ranks beyond the mesh's size sit that one out). Rank 0's results by mesh."""
    rank, out = torch.distributed.get_rank(), {}
    for i, (n_data, n_model) in enumerate(MESHES):
        if i:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
            if rank >= n_data * n_model:
                continue
            pmesh.init_group(f"file://{store_dir}/mesh{i}", n_data * n_model, rank, rank, n_data * n_model, "cpu")
        out[(n_data, n_model)] = _steps_on_mesh(n_data, n_model, pipe, gan_pipe, critics, batch, gb)
    return out


def jax_reference(trees, batch, gb):
    """JAX's one-device gradients, clip norm, first Adam moments and updated
    parameters for the joint step and the GAN pair, on the same trees and batches."""
    import jax
    import jax.numpy as jnp
    import optax

    from gonova_tts_tpu.config import ModelConfig as JModelConfig
    from gonova_tts_tpu.train import step as jstep

    pipe, gan_pipe, critics = trees
    jopt = jstep.make_optimizer(lr=LR, warmup=0, decay_steps=10)
    as_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731

    @jax.jit
    def update(p, grads):
        state = jopt.init(p)
        updates, state = jopt.update(grads, state, p)
        mu = state[1][0].mu  # chain(clip, adamw): adamw's scale_by_adam state
        return optax.apply_updates(p, updates), mu, optax.global_norm(grads)

    def record(p, grads):
        new, mu, norm = update(p, grads)
        return {"grads": flat(grads), "norm": float(norm), "params": flat(new), "mu": flat(mu)}

    jcfg = JModelConfig(**TINY)
    joint = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.tts_loss_fn(p, b, jcfg, jnp.float32, True, align_step=jnp.asarray(0)), has_aux=True
    ))
    p = as_j(pipe)
    (_, metrics), grads = joint(p, as_j(batch))
    ref = {"joint": record(p, grads), "metrics": {k: float(v) for k, v in metrics.items()}}

    d_loss_fn, g_loss_fn = jstep._gan_loss_fns(JModelConfig(**GAN))
    g = as_j(gb)
    gen, disc = as_j({"vocoder": gan_pipe["vocoder"]}), as_j(critics)
    d_loss, d_grads = jax.jit(jax.value_and_grad(d_loss_fn))(disc, gen, g["mel"], g["audio"], 0)
    ref["d_loss"] = float(d_loss)
    ref["disc"] = record(disc, d_grads)
    disc_new = as_j(params.unflatten({k.replace(".", "/"): v for k, v in ref["disc"]["params"].items()}))
    (_, g_metrics), g_grads = jax.jit(jax.value_and_grad(g_loss_fn, has_aux=True))(
        gen, disc_new, g["mel"], g["audio"], g["frame_mask"], 0
    )
    ref["g_metrics"] = {k: float(v) for k, v in g_metrics.items()}
    ref["gen"] = record(gen, g_grads)
    return ref


def one_device(trees, batch, gb):
    """The port's one-device steps on the same inputs: their gradients' distance
    from JAX's is the f32 floor the sharded steps are held to."""
    pipe, gan_pipe, critics = trees
    opt = tstep.make_optimizer(lr=LR, warmup=0, decay_steps=10)
    seen = {}
    st = tstep.init_state(params.from_numpy_tree(pipe, CFG, device="cpu", with_aligner=True), opt)
    _spy(st, seen, "joint")
    tstep.make_train_step(CFG, learn_alignment=True)(st, to_torch(batch))
    model = params.from_numpy_tree(gan_pipe, GCFG, device="cpu")
    gen = tstep.init_state(layers.group(vocoder=model.vocoder), opt)
    disc = tstep.init_state(params.discriminators_from_numpy(critics, GCFG.disc_width, device="cpu"), opt)
    _spy(disc, seen, "disc")
    _spy(gen, seen, "gen")
    d_step, g_step = tstep.make_gan_steps(GCFG)
    t = to_torch(gb)
    disc, _ = d_step(disc, gen.params, t["mel"], t["audio"])
    g_step(gen, disc.params, t["mel"], t["audio"], t["frame_mask"])
    mu = {"joint": _adam_mu(st), "disc": _adam_mu(disc), "gen": _adam_mu(gen)}
    return {
        k: {"grads": {n: g.numpy() for n, g in seen[k][0].items()}, "mu": {n: m.numpy() for n, m in mu[k].items()}}
        for k in seen
    }


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(the workers' results by mesh, the JAX reference, the port's one-device
    results): the workers run while this process computes the other two."""
    tr, batch, gb = trees(), joint_batch(), gan_batch()
    store = str(tmp_path_factory.mktemp("stores"))
    with ThreadPoolExecutor(1) as pool:
        ours = pool.submit(launch.spawn, _steps_on_meshes, 4, "cpu", store, *tr, batch, gb)
        ref = jax_reference(tr, batch, gb)
        plain = one_device(tr, batch, gb)
        return ours.result()[0], ref, plain


def _close_trees(got, want, floor, what, rtol=1e-4, atol=1e-6):
    """Leaf by leaf in L2: ||got - want|| <= rtol * ||want|| + atol * sqrt(size), or
    within twice the one-device port's own distance from `want` (`floor`)."""
    assert sorted(got) == sorted(want) == sorted(floor), what
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w)
        bound = max(rtol * np.linalg.norm(w) + atol * np.sqrt(w.size), 2 * np.linalg.norm(floor[k] - w))
        assert err <= bound, f"{what} {k}: |error| {err:.3g} > {bound:.3g} (|want| {np.linalg.norm(w):.3g})"


@pytest.mark.parametrize("n_data,n_model", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_sharded_steps_match_jax(mesh_runs, n_data, n_model):
    """A sharded joint step and GAN pair on a gloo mesh against JAX's one-device
    gradients of the same losses: the loss and its parts rtol 1e-4; every gradient
    leaf, gathered over 'model', before the clip, rtol 1e-4 / atol 1e-6 in L2 per
    leaf (`_close_trees`; a mean of per-shard means, or a sum over 'model' of
    replicated gradients, is off by 10% and more); the clip's global norm (above 1,
    so the clip acts) rtol 1e-4, and the first Adam moment, which carries the
    clip's scale, as the gradients; the updated parameters within 1e-5 of JAX's
    plain step on >= 99.9% of elements and everywhere within 2 * lr (Adam's
    normalized first step follows the sign of a gradient that is zero in exact
    arithmetic, as the attention key bias's).

    Per leaf in L2, not per element, and never tighter than twice the port's own
    one-device distance from JAX: at this random init the vocoder's gradients reach
    1e7 through the MR-STFT loss's log-magnitude term, where f32 summation order
    alone puts single elements 1e-3 apart (the one-device step against JAX misses
    rtol 1e-4 / atol 1e-6 per element by up to 215 times, on
    vocoder.blocks.0.dw_b), and the critics' leaky-ReLU kinks put some of their
    leaves up to 3e-4 apart in L2 on one device."""
    runs, ref, plain = mesh_runs
    out = runs[(n_data, n_model)]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(out["d_loss"], ref["d_loss"], rtol=1e-4)
    for k, v in ref["g_metrics"].items():
        np.testing.assert_allclose(out["g_metrics"][k], v, rtol=1e-4, err_msg=k)
    for ours, theirs in (("joint", "joint"), ("d", "disc"), ("g", "gen")):
        got, want = out[ours], ref[theirs]
        if n_model > 1:
            assert got["sharded"], f"{ours}: no leaf sharded over 'model'"
        _close_trees(got["grads"], want["grads"], plain[theirs]["grads"], f"{ours} grad")
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-4)
        _close_trees(got["mu"], want["mu"], plain[theirs]["mu"], f"{ours} mu")
        diffs = np.concatenate([np.abs(got["params"][k] - w).ravel() for k, w in want["params"].items()])
        assert (diffs <= 1e-5).mean() >= 0.999 and diffs.max() <= 2 * LR, ours
    assert ref["joint"]["norm"] > 1.0


# ---------------------------------------------------------------- the loop


def _config(**fields):
    cfg = Config()
    cfg.model = ModelConfig(**TINY, **fields, device="cpu")
    return cfg


_HOST_SCRIPT = """
import json, sys, torch
torch.set_num_threads(1)  # its two workers take one thread each
sys.path.insert(0, {repo!r})
from gonova_tts_tpu_torch.config import Config, ModelConfig
from gonova_tts_tpu_torch.engine import multi
from gonova_tts_tpu_torch.train import loop
multi.local_devices = lambda device: [torch.device("cpu")] * 2  # two workers on this host
cfg = Config()
cfg.model = ModelConfig(**{tiny!r}, device="cpu")
print(json.dumps(loop.train(cfg, steps=2, batch_size=4, warmup=1, n_model=2, device="cpu")))
"""


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """Three runs of 2 steps on the synthetic batch, side by side: train(n_data=2,
    n_model=2) called from this (plain) process, with checkpoints at 1 and 2; the
    same on one device; and two "host" processes of 2 workers each under
    TTS_COORDINATOR / TTS_NUM_PROCESSES / TTS_PROCESS_ID (their reports). Then
    train(gan=True) on a small manifest corpus with the critics at width 0.25,
    sharded (n_data=2) and on one device."""
    from gonova_tts_tpu_torch.train import synth_corpus

    root = tmp_path_factory.mktemp("sharded_train")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    hosts = [
        subprocess.Popen(
            [sys.executable, "-c", _HOST_SCRIPT.format(repo=REPO, tiny=TINY)],
            env={**env, "TTS_COORDINATOR": f"127.0.0.1:{port}", "TTS_NUM_PROCESSES": "2", "TTS_PROCESS_ID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    kw = dict(steps=2, batch_size=4, warmup=1, checkpoint_every=1, device="cpu")
    gan_kw = dict(manifest=str(root / "corpus" / "manifest_train.txt"), steps=2, batch_size=2, warmup=1,
                  gan=True, gan_steps=2, device="cpu")
    try:
        with ThreadPoolExecutor(2) as pool:  # the sharded runs' workers beside this process's runs
            sharded = pool.submit(
                loop.train, _config(), checkpoint_dir=str(root / "mesh"), n_data=2, n_model=2, **kw
            )
            synth_corpus.generate_corpus(
                str(root / "corpus"), sentences=synth_corpus.DEFAULT_SENTENCES[:2],
                speakers=synth_corpus.DEFAULT_SPEAKERS[:2], variable=True, holdout=1,
            )
            gan_mesh = pool.submit(
                loop.train, _config(disc_width=0.25), checkpoint_dir=str(root / "gan_mesh"), n_data=2, **gan_kw
            )
            plain = loop.train(_config(), checkpoint_dir=str(root / "one"), **kw)
            gan = {"one": loop.train(_config(disc_width=0.25), checkpoint_dir=str(root / "gan_one"), **gan_kw)}
            sharded, gan["mesh"] = sharded.result(), gan_mesh.result()
        outs = [p.communicate(timeout=300) for p in hosts]
    finally:
        for p in hosts:
            p.kill()
    for p, (_, err) in zip(hosts, outs):
        assert p.returncode == 0, err[-3000:]
    return root, sharded, plain, [json.loads(o.strip().splitlines()[-1]) for o, _ in outs], gan


def test_sharded_train_writes_jax_readable_checkpoints(sharded_run):
    """Rank 0 writes the same files as one device; JAX's restore_params reads them,
    leaf for leaf the one-device run's within Adam's bound (2 * lr per update, the
    sign of a near-zero gradient) and equal in relative L2 to 1e-5; the losses agree
    to rtol 1e-5."""
    from gonova_tts_tpu.train import restore_params

    root, sharded, plain, _, _ = sharded_run
    assert sorted(os.listdir(root / "mesh")) == sorted(os.listdir(root / "one")) == [
        "step_00000001.npz", "step_00000002.npz",
    ]
    for k, v in plain.items():
        np.testing.assert_allclose(sharded[k], v, rtol=1e-5, err_msg=k)
    a = params.flatten(restore_params(str(root / "mesh" / "step_00000002.npz")))
    b = params.flatten(restore_params(str(root / "one" / "step_00000002.npz")))
    assert sorted(a) == sorted(b)
    diff = np.concatenate([(np.asarray(a[k]) - np.asarray(b[k])).ravel() for k in b])
    norm = np.linalg.norm(np.concatenate([np.asarray(b[k]).ravel() for k in b]))
    assert np.linalg.norm(diff) <= 1e-5 * norm and np.abs(diff).max() <= 2 * 2e-4 * 2


def test_two_hosts_agree_with_one_host(sharded_run):
    """Two host processes x 2 workers (the port's counterpart of
    tests/test_parallel_train.py's two-process run) form one 2x2 mesh, 'model'
    inside each host, and report the single-host 2x2 run's losses (rtol 1e-6)."""
    _, sharded, _, reports, _ = sharded_run
    for r in reports:
        for k, v in sharded.items():
            np.testing.assert_allclose(r[k], v, rtol=1e-6, err_msg=k)


def test_sharded_gan_phase(sharded_run):
    """train(gan=True, n_data=2) runs the joint phase and then the adversarial phase
    sharded (the JAX loop's rule: never drop requested parallelism for the GAN
    fine-tune): the same checkpoints as one device (the joint EMA at 2, the end at
    4) and the same final metrics, the GAN pair's included, rtol 1e-4."""
    root, _, _, _, gan = sharded_run
    assert sorted(os.listdir(root / "gan_mesh")) == sorted(os.listdir(root / "gan_one")) == [
        "step_00000002.npz", "step_00000004.npz",
    ]
    assert {"gan_d", "gan_adv", "gan_fm", "gan_mel"} <= set(gan["one"])
    assert sorted(gan["mesh"]) == sorted(gan["one"])
    for k, v in gan["one"].items():
        np.testing.assert_allclose(gan["mesh"][k], v, rtol=1e-4, err_msg=k)
