"""Each cell for a few seconds on the card, as the benchmark's command runs
it. Needs a CUDA card: ``python -m pytest -m cuda port_bench/tests``."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import REPO

CELLS = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        pytest.skip(f"needs {cell['chips']} CUDA card(s)")
    out = subprocess.run([sys.executable, "-m", "port_bench", "--workload", cell["name"],
                          "--seed", str(2**31 + 101), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == cell["chips"]
    assert set(line["metrics"]) == {"setup_s", "answer_s", "answer_p95_s", "peak_gib"}
