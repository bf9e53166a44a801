"""BENCHMARK.json and the files it names: keys, names and units within
the allowed characters, every file found by name, and the result line's
keys."""
import json
import re

import pytest

from perfbench import spec

from . import helpers

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BENCH = spec.load_benchmark()


def test_the_benchmark_has_exactly_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_names_and_units_keep_to_the_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.fullmatch(n), n
    assert len(set(x["name"] for k in ("end_to_end", "per_layer")
                   for x in BENCH[k])) == len(BENCH["end_to_end"]) + len(
                       BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("work", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(work):
    cell = spec.cell(work["name"])
    config = next(c for c in BENCH["configs"] if c["name"] == work["config"])
    assert set(config["reduced"]) <= set(cell.config)
    assert set(cell.limits) >= {"policy_gap_p90", "moves_apart",
                                "rules_apart", "rows_apart"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_the_result_line_has_the_drivers_keys():
    out = helpers.run(helpers.small_cell())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["metrics"]) == {"selfplay_steps_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)
