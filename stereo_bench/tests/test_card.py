"""One short run of each one-card cell on the card, as the driver runs it.
Marked ``cuda``: skipped without a card (run on the machine that has one:
``python -m pytest stereo_bench/tests -m cuda``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from stereo_bench import harness

pytestmark = pytest.mark.cuda
ONE_CARD = [w["name"] for w in harness.manifest()["workloads"] if w["chips"] == 1]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(card, name, traced):
    proc = subprocess.run([sys.executable, "-m", "stereo_bench.run", "--workload", name, "--seed", "3000000019",
                           "--seconds", "2", "--trace", str(traced)], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checked"
