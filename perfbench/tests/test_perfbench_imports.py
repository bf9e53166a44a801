"""What a run loads: neither JAX nor the JAX package (top-level names
compared whole: ``alphatpu_torch`` begins with ``alphatpu``), and the
reference nothing of the program either; a run without a card fails and
prints no result."""
import json
import os
import subprocess
import sys

from perfbench import harness, spec

ROOT = str(spec.ROOT)


def _loaded(code: str) -> set:
    """The top-level module names loaded by ``code`` in a fresh process."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, env=env, cwd=ROOT, check=True,
        timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_names_are_compared_whole():
    assert harness.forbidden_modules(["alphatpu_torch.selfplay", "numpy"]
                                     ) == []
    assert harness.forbidden_modules(["alphatpu.games", "jaxlib.xla"]) == [
        "alphatpu", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _loaded(
        "import torch\ntorch.set_num_threads(1)\n"
        "from perfbench.tests import helpers\n"
        "assert helpers.run(helpers.small_cell(), traced=True)['correct']\n"
        "import perfbench.run")
    assert "alphatpu_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded(
        "import numpy as np\n"
        "from perfbench.reference import games, search\n"
        "g = games.make('gobang13')\n"
        "me, opp, pl = g.initial(3)\n"
        "w = {'base': np.zeros((338, 8), np.float32),"
        " 'res': np.zeros((1, 8, 8), np.float32),"
        " 'policy_w': np.zeros((8, 169), np.float32),"
        " 'policy_b': np.zeros(169, np.float32),"
        " 'value_w': np.zeros((8, 1), np.float32),"
        " 'value_b': np.zeros(1, np.float32)}\n"
        "search.search(g, w, me, opp, pl, np.full((4, 4, 3), 0.5,"
        " np.float32), 1.5)")
    assert not names & (set(harness.FORBIDDEN) | {"alphatpu_torch", "torch"})


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "reversi8x8.selfplay", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA" in p.stderr
