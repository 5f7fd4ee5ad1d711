"""Port models vs the JAX models, f32 on the CPU: weight loading, acoustic
encode/decode/forward, Vocos for both STFT heads, the one-graph pipeline.

Both sides get one seeded JAX parameter tree (loaded into the port by
`params.from_numpy_tree`) and the same numpy inputs: real token ids from the
frontend. Durations and frame counts must be EQUAL; float outputs match to
atol 1e-4 / rtol 1e-3 (f32 through several layers, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonova_tts_tpu.config import ModelConfig as JModelConfig
from gonova_tts_tpu.models import acoustic as jacoustic
from gonova_tts_tpu.models import tts as jtts
from gonova_tts_tpu.models import vocos as jvocos
from gonova_tts_tpu.text import text_to_ids
from gonova_tts_tpu_torch.config import ModelConfig
from gonova_tts_tpu_torch.models import acoustic, params, tts, vocos


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores: torch's own thread pool (8 spinning
    threads per worker) would starve the other workers' tests."""
    torch.set_num_threads(1)


ATOL, RTOL = 1e-4, 1e-3
DEMO = "assets/checkpoints/demo_ema_f16.npz"
TINY = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=2, decoder_layers=2, speaker_dim=32,
    vocos_dim=128, vocos_ff=256, vocos_layers=2, compute_dtype="float32",
)


def close(ours, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JModelConfig(**TINY)
    tree = jax.tree_util.tree_map(np.asarray, jtts.init(jax.random.PRNGKey(7), jcfg))
    return jcfg, tree, params.from_numpy_tree(tree, ModelConfig(**TINY), device="cpu")


def _batch(texts, bucket):
    ids = [text_to_ids(t) for t in texts]
    tokens = np.zeros((len(ids), bucket), np.int32)
    for i, row in enumerate(ids):
        tokens[i, : len(row)] = row
    mask = (np.arange(bucket)[None] < np.asarray([len(r) for r in ids])[:, None]).astype(np.float32)
    return tokens, mask


TEXTS = ["Hello there, world.", "The quick brown fox jumps over 3 lazy dogs."]


def test_demo_checkpoint_round_trip():
    tree, meta = params.load_npz(DEMO)
    cfg = params.infer_vocos_head(tree, ModelConfig(vocos_head="polar"))
    assert cfg.vocos_head == "cartesian"  # head width 1539 = 3 * 513
    model = params.from_numpy_tree(tree, cfg, device="cpu")
    flat = params.flatten(tree)
    state = model.state_dict()
    assert len(flat) == len(state) == 251
    assert sum(v.numel() for v in state.values()) == sum(v.size for v in flat.values())
    for key, value in flat.items():
        np.testing.assert_array_equal(state[key.replace("/", ".")].numpy(), value)
    with np.load(DEMO) as z:
        np.testing.assert_array_equal(
            model.acoustic.encoder.blocks[2].ff1.w.numpy(),
            z["acoustic/encoder/blocks/2/ff1/w"].astype(np.float32),
        )


def test_seeded_jax_tree_loads_and_mismatch_raises(tiny):
    jcfg, tree, model = tiny
    assert set(model.state_dict()) == {k.replace("/", ".") for k in params.flatten(tree)}
    with pytest.raises(ValueError):
        params.from_numpy_tree(tree, ModelConfig(**{**TINY, "d_ff": 256}), device="cpu")


@pytest.mark.parametrize("t", [37, 40])
def test_embed_speaker_matches_jax_through_the_bridge(tiny, rng, t):
    """The speaker subtree of the seeded JAX tree, loaded by `from_numpy_tree`:
    both packages' `embed_speaker` give the same embedding (atol 1e-5)."""
    jcfg, tree, model = tiny
    mel = rng.standard_normal((2, t, jcfg.n_mels)).astype(np.float32)
    mask = (np.arange(t)[None] < np.array([t, t - 11])[:, None]).astype(np.float32)
    ours = tts.embed_speaker(model, torch.as_tensor(mel), torch.as_tensor(mask))
    theirs = jtts.embed_speaker(tree, jnp.asarray(mel), jnp.asarray(mask))
    assert ours.shape == (2, jcfg.speaker_dim) and ours.dtype == torch.float32
    close(ours, theirs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-5)


def test_acoustic_encode_decode_forward(tiny):
    jcfg, tree, model = tiny
    cfg = model.cfg
    tokens, mask = _batch(TEXTS, 64)
    rng = np.random.default_rng(1)
    spk = rng.standard_normal((2, 32)).astype(np.float32) * 0.1
    exagg = np.asarray([0.5, 0.2], np.float32)
    ja = tree["acoustic"]
    targs = [torch.as_tensor(a) for a in (tokens, mask, spk, exagg)]
    jargs = [jnp.asarray(a) for a in (tokens, mask, spk, exagg)]
    je = jacoustic.encode(ja, *jargs, jcfg)
    te = acoustic.encode(model.acoustic, *targs, cfg)
    np.testing.assert_array_equal(te["durations"].numpy(), np.asarray(je["durations"]))
    np.testing.assert_array_equal(te["total_frames"].numpy(), np.asarray(je["total_frames"]))
    for k in ("enc", "spk", "log_durations", "pitch"):
        close(te[k], je[k])
    fit = int(np.asarray(je["total_frames"]).max()) + 8
    for mf, laf in ((512, None), (fit, 512)):
        jd = jacoustic.decode(ja, je["enc"], je["spk"], je["durations"], jargs[1], mf, jcfg, local_attention_from=laf)
        td = acoustic.decode(model.acoustic, te["enc"], te["spk"], te["durations"], targs[1], mf, cfg, local_attention_from=laf)
        close(td["mel"], jd["mel"])
        np.testing.assert_array_equal(td["frame_mask"].numpy(), np.asarray(jd["frame_mask"]))
    jf = jacoustic.forward(ja, *jargs, jcfg)
    tf = acoustic.forward(model.acoustic, *targs, cfg)
    close(tf["mel"], jf["mel"])
    np.testing.assert_array_equal(tf["total_frames"].numpy(), np.asarray(jf["total_frames"]))


@pytest.mark.parametrize("head", ["cartesian", "polar"])
def test_vocos_forward(head, rng):
    jcfg = JModelConfig(**{**TINY, "vocos_head": head})
    jp = jax.tree_util.tree_map(np.asarray, jvocos.init(jax.random.PRNGKey(3), jcfg))
    full = jax.tree_util.tree_map(np.asarray, jtts.init(jax.random.PRNGKey(0), jcfg))
    full["vocoder"] = jp
    model = params.from_numpy_tree(full, ModelConfig(**{**TINY, "vocos_head": head}), device="cpu")
    mel = rng.standard_normal((2, 40, 80)).astype(np.float32)
    ref = jvocos.forward(jp, jnp.asarray(mel), jcfg)
    ours = vocos.forward(model.vocoder, torch.as_tensor(mel), model.cfg)
    assert ours.shape == (2, 40 * 256)
    close(ours, ref, atol=2e-5)
    # The kernel route (plain version on the CPU) gives the same audio.
    kcfg = model.cfg.model_copy(update={"vocos_pallas": True})
    close(vocos.forward(model.vocoder, torch.as_tensor(mel), kcfg), ref, atol=2e-5)


@pytest.mark.parametrize("kernels", [False, True])
def test_vocos_serving_pass_is_row_stable_and_matches_jax(rng, kernels):
    """A pass without autograd (the engine's) takes the tiled products: the audio
    still matches JAX, and a context-padded window reproduces the same samples of
    the longer pass bit for bit (12 frames of context cover the 2-layer stack's
    receptive field, 9, and the iSTFT's 2)."""
    jcfg = JModelConfig(**TINY)
    full = jax.tree_util.tree_map(np.asarray, jtts.init(jax.random.PRNGKey(0), jcfg))
    model = params.from_numpy_tree(full, ModelConfig(**TINY, vocos_pallas=kernels), device="cpu")
    mel = rng.standard_normal((1, 300, 80)).astype(np.float32)
    hop, ctx, stride = 256, 12, 48
    with torch.inference_mode():
        whole = vocos.forward(model.vocoder, torch.as_tensor(mel), model.cfg)
        close(whole, jvocos.forward(full["vocoder"], jnp.asarray(mel), jcfg), atol=2e-5)
        for st in (ctx, 100, 300 - stride - ctx):
            win = vocos.forward(model.vocoder, torch.as_tensor(mel[:, st - ctx : st + stride + ctx]), model.cfg)
            assert torch.equal(win[:, ctx * hop : (ctx + stride) * hop], whole[:, st * hop : (st + stride) * hop])


@pytest.mark.parametrize("kernels", [False, True])
def test_synthesize_matches_jax(tiny, kernels):
    """One-graph pipeline; with kernels=True both sides take their kernel routes
    (the port's plain versions, JAX's Pallas kernels in interpret mode)."""
    jcfg, tree, model = tiny
    flags = {"acoustic_pallas": kernels, "vocos_pallas": kernels}
    jcfg = jcfg.model_copy(update=flags)
    cfg = model.cfg.model_copy(update=flags)
    tokens, mask = _batch(TEXTS, 64)
    spk = np.zeros((2, 32), np.float32)
    exagg = np.full((2,), 0.5, np.float32)
    ref = jtts.synthesize(tree, *(jnp.asarray(a) for a in (tokens, mask, spk, exagg)), jcfg)
    ours = tts.synthesize(model, *(torch.as_tensor(a) for a in (tokens, mask, spk, exagg)), cfg)
    np.testing.assert_array_equal(ours["total_samples"].numpy(), np.asarray(ref["total_samples"]))
    close(ours["audio"], ref["audio"], atol=2e-5)


def test_hifigan_family_is_not_served():
    """The family the port once refused now builds its generator (its serving is
    held against JAX in test_torch_vocoder.py); a family neither package has is
    refused with the JAX package's ValueError."""
    from gonova_tts_tpu_torch.models import vocoder

    assert isinstance(tts.TTS(ModelConfig(**{**TINY, "vocoder_family": "hifigan"})).vocoder, vocoder.Generator)
    with pytest.raises(ValueError, match="unknown vocoder_family"):
        tts.TTS(ModelConfig(**{**TINY, "vocoder_family": "wavenet"}))
