"""Small cells for the CPU tests: the benchmark's own, cut to a few lanes,
rollouts and rounds, and a 4x4 four-in-a-row cell whose games end inside
a call."""
from __future__ import annotations

from time import perf_counter

from perfbench import harness, spec

SMALL = {"num_games": 8, "rollouts": 8, "rounds_per_call": 4,
         "buffer_rows": 4096}
LINE4 = {"name": "gobang4_32x2", "game": "gobang4", "width": 32, "depth": 2,
         "rollouts": 8, "cpuct": 1.5, "temp_moves": 6, "num_games": 16,
         "rounds_per_call": 16, "buffer_rows": 4096, "engine_level": 1,
         "tower_dtype": "float32"}


def small_cell(name: str = "reversi8x8.selfplay", **config) -> spec.Cell:
    c = spec.cell(name)
    return c._replace(config={**c.config, **SMALL, **config},
                      traffic={**c.traffic, "check_lanes": 4})


def line4_cell(**config) -> spec.Cell:
    c = spec.cell("gobang13.selfplay")
    return c._replace(config={**LINE4, **config},
                      traffic={**c.traffic, "check_lanes": 8})


def run(cell: spec.Cell, seed: int = 2**40 + 7, traced: bool = False,
        **kw) -> dict:
    """One run on the CPU whose window is one call."""
    return harness.measure(cell, seed, 0.0, traced, "cpu", perf_counter(),
                           **kw)
