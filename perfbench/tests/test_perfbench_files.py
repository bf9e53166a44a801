"""A configuration, a traffic mix and a per-layer metric that exist only
as new files are found by name and run, with no edit to a file of the
benchmark."""
import json
import shutil

import torch

from perfbench import harness, spec

from . import helpers

torch.set_num_threads(1)


def test_a_new_cell_mix_and_metric_run_from_files_alone(tmp_path):
    folder = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, folder,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (folder / "configs" / "line4_32x2.json").write_text(json.dumps(
        dict(helpers.LINE4, name="line4_32x2")))
    (folder / "traffic" / "short_calls.json").write_text(json.dumps(
        {"kind": "selfplay_continuous", "why": "a throw-away mix",
         "warm_calls": 1, "check_lanes": 4}))
    (folder / "limits" / "line4.short_calls.json").write_text(
        (folder / "limits" / "gobang13.selfplay.json").read_text())
    (folder / "metrics" / "evaluations_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['evaluations'])\n")
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "line4_32x2", "source": "a test",
                             "file": "perfbench/configs/line4_32x2.json",
                             "reduced": []})
    bench["workloads"].append({"name": "line4.short_calls",
                               "config": "line4_32x2",
                               "traffic": "short_calls", "chips": 1,
                               "why": "a throw-away cell"})
    bench["per_layer"].append({"name": "evaluations_seen", "unit": "evals",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step",
                               "moves": "selfplay_steps_per_s",
                               "workloads": ["line4.short_calls"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("line4.short_calls", tmp_path)
    assert cell.traffic["check_lanes"] == 4
    from time import perf_counter
    out = harness.measure(cell, 11, 0.0, True, "cpu", perf_counter(),
                          folder=folder)
    assert out["correct"], out["compared"]
    # one warm-up call is not in the window; one call of 16 lanes x 16
    # rounds x 8 rollouts is
    assert out["metrics"]["evaluations_seen"]["value"] == 16 * 16 * 8
    # a metric that lists its cells reports in those alone
    assert "mfu.selfplay" not in out["metrics"]
