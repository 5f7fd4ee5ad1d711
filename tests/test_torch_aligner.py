"""The port's MAS aligner (`models/aligner.py`) vs the JAX package's, f32 on the CPU.

One seeded JAX aligner subtree is loaded into the port (`params.from_numpy_tree`
with the aligner), and both sides get the same numpy inputs, with ragged token
and frame masks and one all-padding row (as `ManifestDataset` pads a batch).
Tolerances: log-probs and the forward-sum loss rtol 1e-4 (atol 1e-4 on log-probs,
whose entries reach -1e9 at masked tokens: f32 spacing there is 64); durations
exactly equal; the forward-sum gradient w.r.t. log_p rtol 1e-4 (atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.models import aligner as jaligner
from gonova_tts_tpu_torch.config import ModelConfig
from gonova_tts_tpu_torch.models import aligner, params

TINY = dict(
    d_model=32, n_heads=2, d_ff=64, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocos_dim=32, vocos_ff=64, vocos_layers=1,
)
B, L, T = 3, 10, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees():
    """A JAX aligner subtree and the port's aligner holding the same values."""
    tree = {"aligner": jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: jaligner.init(k, JModelConfig(**TINY)))(jax.random.PRNGKey(3))
    )}
    # The learned temperature away from its init, so both softplus terms matter.
    tree["aligner"]["temp"] = np.asarray(0.3, np.float32)
    node = aligner.init(torch.Generator().manual_seed(0), ModelConfig(**TINY))
    node.load_state_dict(
        {k.replace("/", "."): torch.tensor(v) for k, v in params.flatten(tree["aligner"]).items()}
    )

    class Model:
        pass

    model = Model()
    model.aligner = node
    return tree, model


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    l_len, t_len = np.array([10, 7, 0]), np.array([48, 30, 0])
    token_mask = (np.arange(L)[None] < l_len[:, None]).astype(np.float32)
    frame_mask = (np.arange(T)[None] < t_len[:, None]).astype(np.float32)
    tokens = (rng.integers(1, 60, (B, L)) * token_mask).astype(np.int32)
    mel = rng.normal(size=(B, T, 80)).astype(np.float32)
    return tokens, mel, token_mask, frame_mask


@jax.jit
def _jax_log_p(p, tokens, mel, tm, fm, prior):
    pr = jaligner.diagonal_prior(tm, fm) if prior is not None else None
    return jaligner.log_probs(p, tokens, mel, tm, prior=pr, frame_mask=fm)


def jax_log_p(tree, inputs, prior=True):
    tokens, mel, tm, fm = inputs
    return np.array(_jax_log_p(tree["aligner"], tokens, mel, tm, fm, 1.0 if prior else None))


def port_log_p(model, inputs, prior=True):
    tokens, mel, tm, fm = (torch.as_tensor(a) for a in inputs)
    pr = aligner.diagonal_prior(tm, fm) if prior else None
    return aligner.log_probs(model.aligner, tokens, mel, tm, prior=pr, frame_mask=fm)


def test_diagonal_prior(inputs):
    _, _, tm, fm = inputs
    ours = aligner.diagonal_prior(torch.as_tensor(tm), torch.as_tensor(fm), sigma=0.2)
    ref = jaligner.diagonal_prior(jnp.asarray(tm), jnp.asarray(fm), sigma=0.2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prior", [True, False], ids=["prior", "no_prior"])
def test_log_probs(trees, inputs, prior):
    tree, model = trees
    ours = port_log_p(model, inputs, prior).detach().numpy()
    np.testing.assert_allclose(ours, jax_log_p(tree, inputs, prior), rtol=1e-4, atol=1e-4)


def test_log_probs_without_frame_mask(trees, inputs):
    tree, model = trees
    tokens, mel, tm, _ = inputs
    ours = aligner.log_probs(model.aligner, torch.as_tensor(tokens), torch.as_tensor(mel), torch.as_tensor(tm))
    ref = jaligner.log_probs(tree["aligner"], tokens, mel, tm)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_forward_sum_loss_and_its_gradient(trees, inputs):
    tree, model = trees
    _, _, tm, fm = inputs
    log_p = jax_log_p(tree, inputs)
    ref, ref_grad = jax.jit(jax.value_and_grad(lambda lp: jaligner.forward_sum_loss(lp, tm, fm)))(log_p)
    lp_t = torch.tensor(log_p, requires_grad=True)
    ours = aligner.forward_sum_loss(lp_t, torch.as_tensor(tm), torch.as_tensor(fm))
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-4)
    assert np.isfinite(lp_t.grad.numpy()).all()
    np.testing.assert_allclose(lp_t.grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-6)


def test_mas_durations_equal(trees, inputs):
    tree, model = trees
    _, _, tm, fm = inputs
    log_p = jax_log_p(tree, inputs)
    ref = np.asarray(jax.jit(jaligner.mas_durations)(log_p, tm, fm))
    ours = aligner.mas_durations(torch.as_tensor(log_p), torch.as_tensor(tm), torch.as_tensor(fm)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours.sum(-1), fm.sum(-1).astype(np.int32))


def test_mas_durations_ties_stay():
    """Equal scores everywhere: every stay/advance choice is a tie, and a tie
    stays (`advance = prev > best` is strict), so the path advances only when the
    end constraint forces it."""
    tm = np.ones((2, 4), np.float32)
    fm = np.array([[1] * 9, [1] * 6 + [0] * 3], np.float32)
    log_p = np.zeros((2, 9, 4), np.float32)
    log_p[1, :, 2] = -3.0  # one row with a real preference around the ties
    ref = np.asarray(jax.jit(jaligner.mas_durations)(log_p, tm, fm))
    ours = aligner.mas_durations(torch.as_tensor(log_p), torch.as_tensor(tm), torch.as_tensor(fm)).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_bin_loss_token_pitch_diagnostics(trees, inputs):
    tree, _ = trees
    _, _, tm, fm = inputs
    log_p = jax_log_p(tree, inputs)
    dur = np.array(jax.jit(jaligner.mas_durations)(log_p, tm, fm))
    pitch = np.random.default_rng(5).normal(size=fm.shape).astype(np.float32)
    lp_t, dur_t, fm_t = torch.as_tensor(log_p), torch.as_tensor(dur), torch.as_tensor(fm)
    np.testing.assert_allclose(
        float(aligner.bin_loss(lp_t, dur_t, fm_t)), float(jaligner.bin_loss(log_p, dur, fm)), rtol=1e-5
    )
    np.testing.assert_allclose(
        aligner.token_pitch(torch.as_tensor(pitch), dur_t, fm_t).numpy(),
        np.asarray(jaligner.token_pitch(pitch, dur, fm)), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        float(aligner.diagnostics(lp_t, dur_t, fm_t)["align_conf"]),
        float(jaligner.diagnostics(log_p, dur, fm)["align_conf"]), rtol=1e-5,
    )
