"""The control on the card: each cell run at its own size with the
program's int8 weight path (the train cell: the reference in int8 in the
program's place) must come out not correct. Needs a CUDA card: skipped,
with the reason, where none is present."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    for seed in (2 ** 31 + 17, 2 ** 31 + 29, 2 ** 31 + 41):
        out = subprocess.run(
            [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
             cell, "--seed", str(seed), "--seconds", "10", "--trace", "0",
             "--control", "int8"], capture_output=True, text=True,
            timeout=900, cwd=str(ROOT))
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is False, line["checks"]
