"""What a run measures, found by name: ``BENCHMARK.json`` at the root of
the checkout lists the cells and metrics; each configuration, traffic mix,
cell's limits and per-layer metric reader is a file of its own under this
folder:

* ``configs/<config>.json`` - the sizes, as ``BENCHMARK.json`` names the
  file,
* ``traffic/<traffic>.json`` - the traffic mix's parameters, read by the
  one generator (:mod:`perfbench.generator`),
* ``limits/<cell>.json`` - the limit of each number the cell's check
  compares,
* ``metrics/<metric>.py`` - the reader of a per-layer metric: a function
  ``read(ctx)`` that returns the value, or None where it finds nothing.

A later cell, mix or metric is new files and new entries; nothing here
names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the metric entries this cell reports untraced
    per_layer: list  # the metric entries this cell reports traced


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files (under
    ``root/<the benchmark's folder>``) read."""
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    folder = root / Path(configs[w["config"]]["file"]).parent.parent
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(folder / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(folder / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name, config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, folder: Path = HERE):
    """The ``read`` function of ``folder/metrics/<metric>.py``."""
    path = folder / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
