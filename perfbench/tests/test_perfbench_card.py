"""On the card (marked ``cuda``; skipped without one): a short run of
each cell is correct, and the control - the program's bfloat16 tower
against the float32 reference - is not."""
import json
import subprocess
import sys

import pytest

from perfbench import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _run(cell, seed, *extra):
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "2", "--trace", "0", *extra],
        capture_output=True, text=True, cwd=str(spec.ROOT), timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_a_cell_is_correct_and_its_control_is_not(card, cell):
    assert _run(cell, 2**33 + 1)["correct"]
    assert not _run(cell, 2**33 + 1, "--tower-dtype", "bfloat16")["correct"]
