"""The traced reduction and the per-layer readers on synthetic profiler
events, and the net's operations against a hand count."""
from typing import NamedTuple

import pytest
import torch

from perfbench import peaks, spec, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Range(NamedTuple):
    start: float
    end: float


class Event(NamedTuple):
    name: str
    device_type: object
    time_range: Range
    thread: int = 1


def _events():
    return [
        Event(trace.MARK, CPU, Range(0, 1000)),
        Event("cudaGraphLaunch", CPU, Range(10, 20)),
        Event("aten::copy_", CPU, Range(500, 700)),
        Event("cudaMemcpyAsync", CPU, Range(550, 650)),
        Event("other thread", CPU, Range(0, 1000), thread=2),
        Event("void select_apply_packed_kernel<4, 3>(Args)", CUDA,
              Range(100, 300)),
        Event("sgemm", CUDA, Range(250, 400)),  # overlaps the walk
        Event("sgemm", CUDA, Range(800, 900)),
    ]


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    p = trace.reduce(_events(), wall_s=0.001)
    assert p.busy_s == pytest.approx(400e-6)  # 100-400 and 800-900
    assert p.window_s == 0.001
    # gaps 0-100 (under the graph launch? its middle 50 is past it), 400-800
    # (middle 600: the memcpy inside the copy), 900-1000
    assert p.idle_gaps == pytest.approx({"no host op": 200e-6,
                                         "cudaMemcpyAsync": 400e-6})
    b = trace.breakdown(p)
    assert b["device_ops"][0] == ["sgemm", pytest.approx(250e-6)]
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) == 2


def test_the_readers_of_a_traced_call():
    p = trace.reduce(_events(), wall_s=0.001)
    ctx = {"kind": "selfplay", "rollouts": 4, "profile": p,
           "window_s": 2.0, "evaluations": 10**9,
           "flops_per_eval": 4_392_960, "peak_flops": 67e12}
    assert spec.reader("idle_share.selfplay")(ctx) == pytest.approx(60.0)
    assert spec.reader("kernels_per_rollout.selfplay")(ctx) == 0.75
    assert spec.reader("walk_ms_per_rollout.selfplay")(ctx) == \
        pytest.approx(0.2 / 4)
    assert spec.reader("mfu.selfplay")(ctx) == pytest.approx(
        100 * 4_392_960e9 / (2 * 67e12))
    # a reader that finds nothing returns nothing, never 0
    assert spec.reader("walk_ms_per_rollout.selfplay")(
        {**ctx, "profile": p._replace(ops=[("sgemm", 0, 1)])}) is None
    assert spec.reader("idle_share.selfplay")({**ctx, "kind": "duel"}) is None


@pytest.mark.parametrize("config,count", [
    # base 128x512, 8 blocks of 512x512, policy 512x65, value 512x1
    ("reversi8x8_512x8", 2 * (128 * 512 + 8 * 512 * 512 + 512 * 65 + 512)),
    # base 338x512, 6 blocks, policy 512x169, value 512x1
    ("gobang13_512x6", 2 * (338 * 512 + 6 * 512 * 512 + 512 * 169 + 512)),
])
def test_the_nets_operations_are_counted_from_their_shapes(config, count):
    from perfbench import generator
    from perfbench.reference import games
    cfg = spec.cell(next(w["name"] for w in spec.load_benchmark()["workloads"]
                         if w["config"] == config)).config
    shapes = generator.net_shapes(games.make(cfg["game"]), cfg["width"],
                                  cfg["depth"])
    assert peaks.net_flops_per_eval(shapes["base"][0], cfg["width"],
                                    cfg["depth"], shapes["policy_w"][1]) \
        == count
    products = ("base", "res", "policy_w", "value_w")
    assert count == 2 * sum(torch.Size(shapes[k]).numel() for k in products)


def test_the_peak_follows_the_type_the_tower_runs_in(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.set_float32_matmul_precision("highest")
    assert peaks.PEAK_FLOPS[peaks.matmul_type("float32")] == 67e12
    assert peaks.PEAK_FLOPS[peaks.matmul_type("bfloat16")] == 989e12
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert peaks.PEAK_FLOPS[peaks.matmul_type("float32")] == 495e12
