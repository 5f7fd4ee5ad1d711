"""The port's G2P tools against the JAX package's, on the CPU: the trainer's data
(`build_dataset`, `morph_derive`) equal to tools/train_g2p.py's (imported by path,
as it runs), its held-out report and the grader's sections equal to the JAX tools'
on 100 held-out words, and the trainer's `main` at a tiny width."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

from gonova_tts_tpu.text import g2p as jg2p
from gonova_tts_tpu.text import neural_g2p as jng
from gonova_tts_tpu.text.stress import assign_stress as jassign_stress
from gonova_tts_tpu.text.stress import strip_stress as jstrip_stress
from gonova_tts_tpu_torch.text import neural_g2p as ng
from gonova_tts_tpu_torch.tools import g2p_eval, train_g2p

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
def jtools():
    """The JAX package's tools/train_g2p.py and tools/g2p_eval.py, as they run."""
    return _tool("train_g2p"), _tool("g2p_eval")


@pytest.fixture(scope="module")
def primary():
    return jng.load_weights(), ng.load_weights()


@pytest.fixture(scope="module")
def held100():
    held = g2p_eval.held_out_split(dict(jg2p.VENDORED_LEXICON))
    return {w: held[w] for w in sorted(held)[::12][:100]}


def _chars(words):
    return np.stack([ng.encode_word(w) for w in words])


def test_build_dataset_matches_jax_tool(jtools):
    jt, _ = jtools
    ours = train_g2p.build_dataset(compounds=100, seed=1)
    theirs = jt.build_dataset(compounds=100, seed=1)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2] and len(ours[2]) == 1255
    for w in ("walk", "happy", "stop", "bake", "box"):
        assert train_g2p.morph_derive(w, jg2p.VENDORED_LEXICON.get(w, ["AH"])) == jt.morph_derive(
            w, jg2p.VENDORED_LEXICON.get(w, ["AH"]))




def test_held_out_report_matches_jax_tool(jtools, primary, held100):
    _, jeval = jtools
    jtree, tree = primary
    held = {w: jassign_stress(w, p) for w, p in held100.items()}
    ours = train_g2p.held_out_report(ng.from_numpy_tree(tree, device="cpu"), held)
    words = sorted(held)
    pred_ids = np.asarray(jng.greedy_decode(jtree, jnp.asarray(_chars(words))))
    preds = [jng.decode_ids(pred_ids[i]) for i in range(len(words))]
    grade = jeval.grade
    base_ok = [i for i, w in enumerate(words) if jstrip_stress(preds[i]) == jstrip_stress(held[w])]
    theirs = {
        "held_out_neural": grade([(preds[i], held[w]) for i, w in enumerate(words)]),
        "held_out_neural_stressless": grade(
            [(jstrip_stress(preds[i]), jstrip_stress(held[w])) for i, w in enumerate(words)]),
        "stress_acc_given_phonemes": round(
            sum(preds[i] == held[words[i]] for i in base_ok) / max(len(base_ok), 1), 4),
        "held_out_lts_stressless": grade(
            [(jg2p._word_to_phonemes_lts(w.replace("'", "")), jstrip_stress(held[w])) for w in words]),
    }
    assert ours == theirs
    assert 0.3 < ours["held_out_neural_stressless"]["exact_match"] <= 1.0




def test_grader_sections_match_jax(jtools, held100):
    """Each section of the port's g2p_eval on 100 held-out words against the JAX
    tool's arithmetic through the JAX frontend (the same steps as its main)."""
    _, jeval = jtools
    held = held100
    assert g2p_eval.edit_distance(["A", "B", "C"], ["A", "C", "D"]) == jeval.edit_distance(
        ["A", "B", "C"], ["A", "C", "D"]) == 2
    gold = {w: jg2p.VENDORED_LEXICON[w] for w in sorted(jg2p.VENDORED_LEXICON)[::40]}
    assert g2p_eval.full_pipeline(gold) == jeval.grade([(jg2p.word_to_phonemes(w), r) for w, r in gold.items()])
    assert g2p_eval.lts_held_out(held) == jeval.grade(
        [(jg2p._word_to_phonemes_lts(w.replace("'", "")), r) for w, r in held.items()])
    neural, neural_stress = g2p_eval.neural_held_out(held)
    preds = jng.predict_words(sorted(held))
    pairs = [(jstrip_stress(preds[w]), held[w]) for w in sorted(held)]
    spairs = [(preds[w], jassign_stress(w, held[w])) for w in sorted(held)]
    ok = [i for i, (p, r) in enumerate(pairs) if p == r]
    assert neural == jeval.grade(pairs)
    assert neural_stress == {**jeval.grade(spairs), "stress_acc_given_phonemes": round(
        sum(spairs[i][0] == spairs[i][1] for i in ok) / max(len(ok), 1), 4)}
    lexicon_sans = {k: v for k, v in jg2p.LEXICON.items() if k not in held}
    resolved = [jg2p.resolve_oov(w, lexicon_sans) for w in sorted(held)]
    oov = jeval.grade([(jstrip_stress(p), held[w]) for (p, _), w in zip(resolved, sorted(held))])
    tiers = [t for _, t in resolved]
    oov["morph_share"] = round((tiers.count("morph") + tiers.count("morph_arb")) / len(held), 4)
    oov["morph_arb_share"] = round(tiers.count("morph_arb") / len(held), 4)
    assert g2p_eval.oov_pipeline(held) == oov
    assert g2p_eval.homographs() == (62, 62)
    assert g2p_eval.passes({"full_pipeline": {"exact_match": 0.9}, "homographs_ok": "62/62"})
    assert not g2p_eval.passes({"full_pipeline": {"exact_match": 1.0}, "homographs_ok": "61/62"})




def test_train_main_on_the_cpu(tmp_path, monkeypatch, held100):
    """main at a tiny width for two steps: the report's keys, the file in JAX's format."""
    words = [w for w in sorted(jg2p.VENDORED_LEXICON)[:100] if ng.encode_word(w) is not None and w not in held100]
    x = _chars(words)
    y = np.stack([ng.encode_phonemes(jassign_stress(w, jg2p.VENDORED_LEXICON[w])) for w in words])
    held = {w: jassign_stress(w, p) for w, p in list(held100.items())[:20]}
    monkeypatch.setattr(train_g2p, "build_dataset", lambda **kw: (x, y, held))
    path = str(tmp_path / "g2p" / "member.npz")
    report = train_g2p.main(["--steps", "2", "--batch", "8", "--d-model", "32", "--d-ff", "64", "--enc-layers", "1",
                             "--dec-layers", "2", "--device", "cpu", "--save-path", path])
    assert set(report) == {"held_out_neural", "held_out_neural_stressless", "stress_acc_given_phonemes",
                           "held_out_lts_stressless"}
    assert report["held_out_neural"]["n"] == 20
    with np.load(path) as f:
        assert list(f["meta_layers"]) == [1, 2]
    assert train_g2p.SAVE_PATH.endswith("build/g2p/g2p_weights.npz")
    assert "gonova_tts_tpu/" not in train_g2p.SAVE_PATH.replace("gonova_tts_tpu_torch", "")
