"""On a card: one short run of each cell through the benchmark's command."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from tts_bench import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c["name"] for c in spec.benchmark()["workloads"]])
def test_cell_runs_correct(card, name):
    out = subprocess.run(
        [sys.executable, "tts_bench/run.py", "--workload", name, "--seed", "2718281828459", "--seconds", "5",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True, timeout=600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu"
