"""The traced part of a run: one whole unit of the program's work under
``torch.profiler``, reduced to what the per-layer readers and the result's
``breakdown`` take.

* the device's operations (kernels, copies, fills), by name, start and
  end on the profiler's clock,
* busy: the union of their intervals inside the unit's window (the
  unit's call and the wait for the device, marked by a
  ``record_function``), and the window's length,
* the idle gaps inside that window, each named by what the host was doing
  at its middle: the innermost host operation open then on the thread
  that ran the unit.
"""
from __future__ import annotations

from collections import defaultdict
from time import perf_counter
from typing import Callable, NamedTuple

import torch

MARK = "perfbench.traced_unit"
TOP = 10


class Profile(NamedTuple):
    ops: list  # (name, start_us, end_us) of every device operation
    busy_s: float
    window_s: float  # the host clock's seconds of the unit
    idle_gaps: dict  # host operation -> seconds the device idled under it


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events, wall_s: float) -> Profile:
    """A :class:`Profile` of the profiler's ``events``."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    mark = next(e for e in host if e.name == MARK)
    w0, w1 = mark.time_range.start, mark.time_range.end
    # the mark's own span on the device's timeline is no operation
    ops = [(e.name, e.time_range.start, e.time_range.end)
           for e in events if e.device_type == cuda and e.name != MARK]
    busy = _union((max(a, w0), min(b, w1)) for _, a, b in ops
                  if b > w0 and a < w1)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    # the host's operations on the unit's thread nest: sweep the gaps in
    # time order with a stack of the operations open
    inner = sorted((e for e in host if e is not mark
                    and e.thread == mark.thread),
                   key=lambda e: e.time_range.start)
    idle, stack, i = defaultdict(float), [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(inner) and inner[i].time_range.start <= mid:
            while stack and stack[-1].time_range.end < inner[i].time_range.start:
                stack.pop()
            stack.append(inner[i])
            i += 1
        while stack and stack[-1].time_range.end < mid:
            stack.pop()
        idle[stack[-1].name if stack else "no host op"] += (b - a) / 1e6
    return Profile(ops, sum(b - a for a, b in busy) / 1e6, wall_s,
                   dict(idle))


def profile(unit: Callable[[], None], device: torch.device) -> Profile:
    """Run ``unit()`` once under the profiler, to the device's end."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            t0 = perf_counter()
            unit()
            torch.cuda.synchronize(device)
            wall = perf_counter() - t0
    return reduce(prof.events(), wall)


def breakdown(p: Profile) -> dict:
    """The device operations of most time and the host operations the
    device idled under longest, ``TOP`` each, ``[name, seconds]``."""
    by_name = defaultdict(float)
    for name, a, b in p.ops:
        by_name[name] += (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:TOP]
    return {"device_ops": top(by_name), "idle_gaps": top(p.idle_gaps)}
