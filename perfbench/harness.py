"""One run of one cell: set-up, the measured window, the traced unit, the
check.  :mod:`perfbench.run` is its command line; the tests call
:func:`measure` on the CPU at small sizes."""
from __future__ import annotations

import contextlib
import gc
import os
import sys
from time import perf_counter

import numpy as np
import torch

from . import check, generator, peaks, spec, trace

# the JAX package and JAX itself, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "alphatpu")
# the program's switches of its search engine, set from the configuration
ENGINE_SWITCHES = ("ALPHATPU_PACK", "ALPHATPU_NO_PACK", "ALPHATPU_BF16_STATS")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``sys.modules``' (whole names:
    ``alphatpu_torch`` is not ``alphatpu``)."""
    names = {m.split(".")[0] for m in (modules if modules is not None
                                       else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


@contextlib.contextmanager
def engine(level: int):
    """The program's engine switches as the configuration states them;
    the caller's restored after."""
    saved = {k: os.environ.pop(k, None) for k in ENGINE_SWITCHES}
    os.environ["ALPHATPU_PACK"] = str(level)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def measure(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device, t0: float, tower_dtype: str | None = None,
            folder=spec.HERE) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, maybe ``breakdown``, and
    ``compared``).  ``t0``: the host clock at the process's start, from
    which set-up is counted.  ``tower_dtype`` runs the program's tower in
    another type than the configuration states (the check's control)."""
    t_in = perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix = cell.config, cell.traffic
    with engine(cfg["engine_level"]):
        run = generator.KINDS[mix["kind"]](cfg, mix, seed, dev, tower_dtype)
        generator.sync(dev)
        t_made = perf_counter()
        for _ in range(mix["warm_calls"]):
            run.call()
        generator.sync(dev)
        setup_s = perf_counter() - t0
        parts = {"start_s": t_in - t0, "inputs_s": t_made - t_in,
                 "warm_calls_s": t0 + setup_s - t_made}
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        units, window_s = run.window(seconds)
        call_s = np.diff(run.call_ends, prepend=0.0).round(4).tolist()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        last_call = run.last  # the window's last call, the one checked
        e2e = run.end_to_end(units, window_s)
        e2e["setup_s"] = setup_s
        metrics, breakdown, busy = {}, None, None
        if traced:
            prof = trace.profile(run.call, dev) if cuda else None
            ctx = {**run.counts(), "profile": prof, "window_s": window_s,
                   "evaluations": run.evaluations(units),
                   "flops_per_eval": peaks.net_flops_per_eval(
                       run.shapes["base"][0], cfg["width"], cfg["depth"],
                       run.ref_game.actions),
                   "peak_flops": peaks.PEAK_FLOPS[
                       peaks.matmul_type(run.tower_dtype)]}
            for m in cell.per_layer:
                value = spec.reader(m["name"], folder)(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if prof is not None:
                breakdown = trace.breakdown(prof)
                busy = (prof.busy_s, prof.window_s)
        else:
            metrics = {m["name"]: {"value": e2e[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        attempted, failed = run.moves(units), run.failed()

        # the check, once the window has closed and the peak is read: the
        # call's records to the host, the program's state freed, the
        # reference on the host
        rng = np.random.default_rng(generator.derive(seed, "check"))
        records = check.gather(run, last_call, mix["check_lanes"], rng)
        rng_state = last_call.rng_state
        weights = {k: w.cpu().numpy() for k, w in run.weights.items()}
        T, R, G, D = run.T, run.R, run.G, min(run.ref_game.max_length, run.R)
        ref_game = run.ref_game
        del run, last_call
        from alphatpu_torch import graphs
        graphs.clear_cache()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        probs, u = check.uniforms(rng_state, dev, T, R, D, G,
                                  records.lanes)
        numbers = check.judge(ref_game, weights, records, probs, u,
                              cfg["cpuct"], cfg["temp_moves"])
    correct, rows = check.verdict(numbers, cell.limits)
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    if busy is not None:
        info["busy_s"], info["window_s"] = busy
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup_parts"] = parts
    out["call_s"] = call_s
    out["checked"] = {k: v for k, v in numbers.items()
                      if k not in check.NUMBERS}
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}
    return out
