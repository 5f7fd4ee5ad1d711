"""The port stands alone: no module of gonova_tts_tpu_torch, and neither
chip_smoke.py nor parity_gpu.py, imports jax, optax, orbax or anything of the JAX
package gonova_tts_tpu (AST scan, so lazy imports inside functions count too)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "gonova_tts_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "parity_gpu.py"]
FORBIDDEN = ("jax", "jaxlib", "gonova_tts_tpu", "flax", "optax", "orbax")


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
            "import_module", "__import__",
        ):
            yield from (a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.name for p in FILES}
    assert {"engine.py", "transformer_stack.py", "vocos_stack.py", "neural_g2p.py", "chip_smoke.py"} <= names
    assert {"mel_spectrogram.py", "convnext_block.py", "resample.py", "mel.py", "speaker.py", "batcher.py",
            "voice_cache.py", "voice_manager.py", "queue_manager.py", "rate_limiter.py", "synthesizer.py",
            "wavio.py", "jsonlog.py", "native.py"} <= names
    assert {"server.py", "encode.py", "ola.py", "cli.py", "registry.py"} <= names
    assert {"losses.py", "step.py", "loop.py", "data.py", "synth_corpus.py", "checkpoint.py", "aligner.py",
            "pitch.py", "parity_gpu.py"} <= names
    assert {"vocoder.py", "vocoder_folded.py", "_jax_prng.py"} <= names
    assert {"multi.py", "mesh.py", "tp.py", "launch.py"} <= names
    assert {"train_g2p.py", "g2p_eval.py", "eval_checkpoint.py", "clone_eval.py", "prof.py"} <= names
    assert {"align_diag.py", "jitter_floor.py", "ws_smoke.py", "g2p_coverage.py", "memory_socket.py"} <= names
    assert {"bench.py", "bench_suite.py", "mfu.py", "bench_tstack.py", "bench_acoustic.py", "bench_vocos_attr.py",
            "bench_hifigan.py", "_bench_util.py"} <= names
