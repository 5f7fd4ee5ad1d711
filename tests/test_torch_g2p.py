"""The port's G2P model and its trainer's arithmetic against the JAX package, on the CPU.

Weights carried from a JAX `init` tree and from the vendored primary; teacher
logits within 1e-5; greedy ids equal to JAX's `greedy_decode` and, up to the
first EOS, to the numpy serving decoder at beam 1; `save_weights` read back by
both packages (float16 leaves, `meta_layers` at 4+4), and a port-trained file
decoding the same ids in JAX; the trainer's loss within 1e-6 of the JAX tool's
`loss_fn`, its schedule equal to optax's, three AdamW steps within 1e-5 of optax
in relative L2 (update 0 at learning rate 0), tail averaging. The data, the
held-out report and the grader are in test_torch_g2p_tools.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from threadpoolctl import threadpool_limits
import torch

from gonova_tts_tpu.text import g2p as jg2p
from gonova_tts_tpu.text import neural_g2p as jng
from gonova_tts_tpu.text.stress import assign_stress as jassign_stress
from gonova_tts_tpu_torch.text import neural_g2p as ng
from gonova_tts_tpu_torch.tools import g2p_eval, train_g2p

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two BLAS and two torch threads: tier-1 runs six test workers at once, and
    the wall-clock tests of other files fail when these take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_tree():
    return jax.tree.map(np.asarray, jng.init(jax.random.PRNGKey(3), 32, 64, 1, 1))


@pytest.fixture(scope="module")
def primary():
    return jng.load_weights(), ng.load_weights()


@pytest.fixture(scope="module")
def held100():
    gold = dict(jg2p.VENDORED_LEXICON)
    held = g2p_eval.held_out_split(gold)
    return {w: held[w] for w in sorted(held)[::12][:100]}


def _chars(words):
    return np.stack([ng.encode_word(w) for w in words])


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _rel_l2(a, b):
    a = np.concatenate([x.ravel() for x in a])
    b = np.concatenate([x.ravel() for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def test_weights_carried_from_jax(tiny_tree, primary):
    model = ng.from_numpy_tree(tiny_tree, device="cpu")
    assert isinstance(model, ng.G2P) and len(model["enc"]) == len(model["dec"]) == 1
    back = ng.to_numpy_tree(model)
    for a, b in zip(_leaves(tiny_tree), _leaves(back)):
        np.testing.assert_array_equal(a, b)
    jtree, tree = primary
    model = ng.from_numpy_tree(tree, device="cpu")
    assert model["char_embed"]["table"].shape == (ng.N_CHAR_VOCAB, 192) and len(model["dec"]) == 3
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in _leaves(jtree))
    for a, b in zip(_leaves(jtree), _leaves(ng.to_numpy_tree(model))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ng.from_numpy_tree({**tree, "out": {"w": np.zeros((192, 5), np.float32), "b": np.zeros(5, np.float32)}},
                           device="cpu")


def test_init_builds_jax_shapes():
    model = ng.init(torch.Generator().manual_seed(0), 32, 64, 2, 1, device="cpu")
    ref = jax.tree.map(np.shape, jng.init(jax.random.PRNGKey(0), 32, 64, 2, 1))
    ours = jax.tree.map(np.shape, ng.to_numpy_tree(model))
    assert ours == ref
    assert not any(p.requires_grad for p in model.parameters())
    if not torch.cuda.is_available():  # the default device is the card: no silent CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ng.init(torch.Generator(), 32, 64, 1, 1)


@pytest.mark.parametrize("which", ["tiny", "primary"])
def test_teacher_logits_match_jax(which, tiny_tree, primary, held100):
    tree = tiny_tree if which == "tiny" else primary[1]
    jtree = tiny_tree if which == "tiny" else primary[0]
    words = sorted(held100)[:32]
    chars = _chars(words)
    targets = np.stack([ng.encode_phonemes(jassign_stress(w, held100[w])) for w in words])
    ours = ng.teacher_logits(ng.from_numpy_tree(tree, device="cpu"), torch.as_tensor(chars).long(),
                             torch.as_tensor(targets).long())
    theirs = np.asarray(jng.teacher_logits(jtree, jnp.asarray(chars), jnp.asarray(targets)))
    assert ours.shape == theirs.shape == (32, ng.MAX_PHONS, ng.N_PHON_VOCAB)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "primary"])
def test_greedy_decode_matches_jax_and_numpy(which, tiny_tree, primary, held100):
    tree = tiny_tree if which == "tiny" else primary[1]
    jtree = tiny_tree if which == "tiny" else primary[0]
    chars = _chars(sorted(held100))
    ours = ng.greedy_decode(ng.from_numpy_tree(tree, device="cpu"), torch.as_tensor(chars).long()).numpy()
    assert ours.shape == (len(chars), ng.MAX_PHONS)
    np.testing.assert_array_equal(ours, np.asarray(jng.greedy_decode(jtree, jnp.asarray(chars))))
    beam1 = ng._np_predict_batch([ng._prepare(tree)], chars, beam=1)
    assert [ng.decode_ids(r) for r in ours] == [ng.decode_ids(r) for r in beam1]


def test_save_weights_round_trips(tmp_path, tiny_tree):
    # Port → JAX, at 4+4 layers (meta_layers read by both packages).
    model = ng.init(torch.Generator().manual_seed(1), 32, 64, 4, 4, device="cpu")
    path = str(tmp_path / "port.npz")
    ng.save_weights(model, path)
    with np.load(path) as f:
        assert list(f["meta_layers"]) == [4, 4] and f["p0"].dtype == np.float16
    jtree, tree = jng.load_weights(path), ng.load_weights(path)
    f16 = [a.astype(np.float16).astype(np.float32) for a in _leaves(ng.to_numpy_tree(model))]
    for a, b, c in zip(f16, _leaves(jtree), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # JAX → port.
    jpath = str(tmp_path / "jax.npz")
    jng.save_weights(jax.tree.map(jnp.asarray, tiny_tree), jpath)
    back = ng.to_numpy_tree(ng.from_numpy_tree(ng.load_weights(jpath), device="cpu"))
    for a, b in zip(_leaves(tiny_tree), _leaves(back)):
        np.testing.assert_array_equal(a.astype(np.float16).astype(np.float32), b)


def test_port_trained_file_decodes_the_same_in_jax(tmp_path, held100):
    """A member trained by the port is served by the JAX package: the same ids."""
    x, y, _ = _small_data(held100)
    model = ng.init(torch.Generator().manual_seed(0), 32, 64, 1, 1, device="cpu")
    train_g2p.train(model, x, y, steps=3, batch=16, lr=3e-3, log=None)
    path = str(tmp_path / "trained.npz")
    ng.save_weights(model, path)
    chars = _chars(sorted(held100))
    ours = ng.greedy_decode(ng.from_numpy_tree(ng.load_weights(path), device="cpu"), torch.as_tensor(chars).long())
    theirs = np.asarray(jng.greedy_decode(jng.load_weights(path), jnp.asarray(chars)))
    np.testing.assert_array_equal(ours.numpy(), theirs)


def _small_data(held):
    words = [w for w in sorted(jg2p.VENDORED_LEXICON)[:300] if ng.encode_word(w) is not None]
    pairs = [(w, jassign_stress(w, jg2p.VENDORED_LEXICON[w])) for w in words if w not in held]
    pairs = [(w, p) for w, p in pairs if ng.encode_phonemes(p) is not None]
    return _chars([w for w, _ in pairs]), np.stack([ng.encode_phonemes(p) for _, p in pairs]), pairs


def _jax_loss(p, bx, by, smooth):
    """tools/train_g2p.py's loss_fn."""
    logits = jng.teacher_logits(p, bx, by)
    mask = (by != jng.P_PAD).astype(jnp.float32)
    onehot = jax.nn.one_hot(by, logits.shape[-1])
    targets = onehot * (1.0 - smooth) + smooth / logits.shape[-1]
    ll = optax.softmax_cross_entropy(logits, targets)
    return jnp.sum(ll * mask) / jnp.maximum(jnp.sum(mask), 1.0)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_loss_matches_tool_loss_fn(smooth, tiny_tree, held100):
    x, y, _ = _small_data(held100)
    x, y = x[:64], y[:64]
    ours = train_g2p.loss_fn(
        ng.teacher_logits(ng.from_numpy_tree(tiny_tree, device="cpu"), torch.as_tensor(x).long(),
                          torch.as_tensor(y).long()), torch.as_tensor(y).long(), smooth)
    theirs = float(jax.jit(_jax_loss, static_argnums=3)(tiny_tree, jnp.asarray(x), jnp.asarray(y), smooth))
    assert abs(float(ours) - theirs) <= 1e-6 * max(1.0, abs(theirs))
    empty = torch.zeros((2, ng.MAX_PHONS), dtype=torch.long)  # all pad: divided by max(0, 1)
    assert float(train_g2p.loss_fn(torch.zeros((2, ng.MAX_PHONS, ng.N_PHON_VOCAB)), empty, smooth)) == 0.0


@pytest.mark.parametrize("steps", [3, 40, 4000])
def test_schedule_matches_optax(steps):
    lr = 3e-4
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, min(200, max(1, steps // 10)), steps, lr * 0.02)
    for count in sorted({0, 1, 2, steps // 10, steps // 2, steps - 1, steps, steps + 5}):
        np.testing.assert_allclose(train_g2p.schedule(count, lr, steps), float(sched(count)), rtol=1e-5, atol=1e-12)


def _adamw_runs(tiny_tree, held100, lr, wd, steps=3, smooth=0.1, batch=16):
    """`steps` updates of optax.adamw(warmup_cosine_decay_schedule) and of
    train_g2p.train from one tree and seed 0: (the flatten-order leaf paths, the
    initial leaves, JAX's leaves after each update, the port's, the losses of both)."""
    x, y, _ = _small_data(held100)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, min(200, max(1, steps // 10)), steps, lr * 0.02)
    opt = optax.adamw(sched, weight_decay=wd)
    p = jax.tree.map(jnp.asarray, tiny_tree)
    state = opt.init(p)

    @jax.jit
    def step(p, state, bx, by):
        loss, g = jax.value_and_grad(_jax_loss)(p, bx, by, smooth)
        updates, state = opt.update(g, state, p)
        return optax.apply_updates(p, updates), state, loss

    rng = np.random.default_rng(0)
    jlosses, jparams = [], []
    for _ in range(steps):
        idx = rng.integers(0, len(x), size=min(batch, len(x)))
        p, state, loss = step(p, state, jnp.asarray(x[idx]), jnp.asarray(y[idx]))
        jlosses.append(float(loss))
        jparams.append(_leaves(p))

    model = ng.from_numpy_tree(tiny_tree, device="cpu")
    snaps = []
    losses = train_g2p.train(
        model, x, y, steps=steps, batch=batch, lr=lr, seed=0, weight_decay=wd, label_smooth=smooth, log=None,
        on_step=lambda i: snaps.append([v.detach().clone().numpy() for v in model.state_dict().values()]),
    )
    assert not any(p.requires_grad for p in model.parameters())
    order = [".".join(map(str, path)) for path in ng._flatten_order(ng.to_numpy_tree(model))]
    keys = list(model.state_dict())
    ours = [[snap[keys.index(k)] for k in order] for snap in snaps]
    return order, _leaves(tiny_tree), jparams, ours, jlosses, losses


def test_three_adamw_steps_match_optax(tiny_tree, held100):
    """Default hyperparameters at d=32, 1+1 layers, batch 16 from seed 0. The
    attention key biases have a zero true gradient (softmax ignores a constant
    logit shift), so Adam moves them by rounding noise in both packages; they are
    in the overall L2 like every other leaf."""
    order, p0, jparams, ours, jlosses, losses = _adamw_runs(tiny_tree, held100, lr=3e-4, wd=3e-3)
    assert set(losses) == {0, 2}
    np.testing.assert_allclose([losses[0], losses[2]], [jlosses[0], jlosses[2]], rtol=1e-6)
    for i in range(3):
        assert _rel_l2(jparams[i], ours[i]) <= 1e-5, i
    # Update 0 runs at learning rate 0: nothing moves, in either package.
    for a, b, c in zip(p0, jparams[0], ours[0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_adamw_decays_every_leaf_as_optax(tiny_tree, held100):
    """At lr 1e-2 and weight decay 1.0 the decoupled decay (lr * wd * p) is a large
    part of each update, so the parameters after each update hold the trainer to
    optax.adamw's one group that decays every leaf: within 1e-5 in relative L2 over
    all leaves, and over the vectors alone (biases, LayerNorm gains and shifts). A
    trainer without decay reads ~1e-2 on both. The attention key biases are left
    out: their true gradient is zero, and at this rate Adam's steps on their
    rounding noise (either sign, ~lr) would outweigh the rest."""
    order, p0, jparams, ours, _, _ = _adamw_runs(tiny_tree, held100, lr=1e-2, wd=1.0)
    keep = [n for n, path in enumerate(order) if not path.endswith(".k.b")]
    vectors = [n for n in keep if p0[n].ndim == 1]
    assert len(keep) < len(order) and any(order[n].endswith(".g") for n in vectors)
    for i in range(3):
        for sel in (keep, vectors):
            assert _rel_l2([jparams[i][n] for n in sel], [ours[i][n] for n in sel]) <= 1e-5, i


def test_tail_averaging(tiny_tree, held100):
    """--avg-tail: the mean of the snapshots after updates avg_from, avg_from + 20,
    ... (avg_from = steps * (1 - tail)), as the JAX tool takes them."""
    x, y, _ = _small_data(held100)
    steps, tail = 50, 0.6
    model = ng.from_numpy_tree(tiny_tree, device="cpu")
    snaps = {}
    train_g2p.train(
        model, x, y, steps=steps, batch=8, lr=1e-3, avg_tail=tail, log=None,
        on_step=lambda i: snaps.__setitem__(i, {k: v.detach().clone() for k, v in model.state_dict().items()}),
    )
    avg_from = int(steps * (1.0 - tail))
    taken = [i for i in range(steps) if i >= avg_from and (i - avg_from) % 20 == 0]
    assert taken == [20, 40]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sum(snaps[i][k] for i in taken) / len(taken), rtol=1e-6, atol=1e-7)


