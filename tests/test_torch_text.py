"""The port's own text frontend vs the JAX package's: identical token ids.

Sentences cover numbers, currency, abbreviations and out-of-lexicon words, which go
through the neural G2P ensemble (the port's numpy decoder, reading the weights in
place). Exact equality: both frontends are the same host-side algorithm.
"""

import numpy as np
import pytest
import torch

from gonova_tts_tpu.text import frontend as jfrontend
from gonova_tts_tpu.text import g2p as jg2p
from gonova_tts_tpu.text import neural_g2p as jneural
from gonova_tts_tpu_torch.text import frontend, g2p, neural_g2p


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores: torch's own thread pool (8 spinning
    threads per worker) would starve the other workers' tests."""
    torch.set_num_threads(1)


SENTENCES = [
    "Dr. Smith paid $42.50 on Jan. 3rd, 2021 for 17 widgets.",
    "The flibbertigibbet quoxified the zentrivalar gromblets at 7:45 p.m.",
    "Mr. Jones owes 1,250 dollars and 99 cents, i.e. about 10% more.",
    "Snorklewhist met them at St. Mary's on 5th Ave.",
]
OOV = ["flibbertigibbet", "quoxified", "zentrivalar", "gromblets", "snorklewhist"]


def test_oov_words_are_out_of_lexicon():
    lex = g2p.LEXICON
    assert all(w not in lex for w in OOV)
    assert neural_g2p.available()  # weights found in place: no quiet LTS fallback


@pytest.mark.parametrize("stress", [False, True])
def test_text_to_ids_matches_jax(stress):
    for s in SENTENCES:
        assert frontend.text_to_ids(s, with_stress=stress) == jfrontend.text_to_ids(s, with_stress=stress)


def test_neural_ensemble_matches_jax():
    ours = neural_g2p.predict_words(OOV)
    ref = jneural.predict_words(OOV)
    assert ours == ref
    assert all(ours[w] for w in OOV)
    # The weight loader rebuilds JAX's flatten order (dict keys sorted).
    tree = neural_g2p.load_weights()
    jtree = jneural.load_weights()
    np.testing.assert_array_equal(tree["dec"][1]["cross"]["v"]["w"], np.asarray(jtree["dec"][1]["cross"]["v"]["w"]))
    np.testing.assert_array_equal(tree["out"]["b"], np.asarray(jtree["out"]["b"]))


def test_segmentation_and_buckets_match_jax():
    text = " ".join(SENTENCES)
    assert frontend.segment_text(text) == jfrontend.segment_text(text)
    ids = [frontend.text_to_ids(s) for s in SENTENCES]
    ours = frontend.batch_to_bucket(ids, [32, 64, 128])
    ref = jfrontend.batch_to_bucket(ids, [32, 64, 128])
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert g2p.get_tier_counts().keys() == jg2p.get_tier_counts().keys()
