"""Benchmark: continuous-selfplay throughput of the port on one card.

    python -m alphatpu_torch.bench

Counterpart of the root ``bench.py`` (which measures the JAX reference):
one continuous-selfplay generation - 64 MCTS rollouts per move, the
per-game reference net - and its rate in env-steps/s (moves decided per
second, each backed by a full search), printed as ONE JSON line.

The workload is bench.py's, step for step: ``max(168, 2 * max_game_length)``
rounds, run as ``ceil(rounds / chunk)`` chained ``selfplay_continuous``
calls through the episode carry; lanes past 8192 scheduled as 8192-lane
superblocks one after another (a choice bench.py made from TPU
measurements, kept so that the same metric name means the same work); a
2,000,000-row buffer.  The net is ``MLP.from_seed`` (numpy Glorot weights):
the reference's JAX initializer cannot be reproduced without JAX, and the
weights do not change the work.

Timing: one warm-up generation from ``seed + 1`` (it also builds the
kernels and, on the card, captures the round that every later round
replays: :mod:`alphatpu_torch.graphs`), then three timed generations,
each from a fresh generator seeded ``seed + 2`` (identical work), each
timed on the host clock up to a ``torch.cuda.synchronize``.  ``value`` is the median; ``extra.wall_s_all``
holds the three walls and ``extra.spread`` ``(max - min) / median``.

Checks, each raising: the three repeats wrote and carried the same rows;
no illegal move; on the card, each timed generation launched every kernel
exactly as often as :func:`owed_launches` says (the launch counters move
only on CUDA tensors, so on the CPU the plain versions run and the check is
skipped).  The engine level is pinned for the run (``ALPHATPU_PACK``,
``ALPHATPU_NO_PACK``; the caller's values are restored): level 1 unless
the caller asks for 0 (``select_apply`` on three f32 planes, what bench.py
runs under ``ALPHATPU_NO_PACK=1``) or 2.  Under ``ALPHATPU_BF16_STATS``
the search stores its stats as bf16 planes (``tree.stat_dtype_for``) and
runs level 0 whatever is asked, as bench.py does; the metric name then
ends in ``_bf16stats`` (``_bf16`` names the bf16 tower).

Fields beyond bench.py's: ``pack_level``, ``stat_dtype``, ``rounds_played``,
``wall_s_all``, ``spread``, ``illegal_moves``, ``launches`` and
``launches_owed`` (per kernel wrapper, one timed generation),
``captured``, ``graph_replays`` and ``graph_captures`` (one timed
generation: every round and every call's tail a replay on the card),
``warmup_graph_captures``,
``capture_s``, ``graph_nodes`` and ``graph_pool_bytes`` (the warm-up's
captures: seconds, nodes, device memory reserved while capturing),
``peak_mem_bytes`` (over the timed generations), ``device``, ``nn_mfu``
against ``peak_flops`` (the published H100 SXM peak of the tower's dtype,
named in ``peak``; null on the CPU).  bench.py's ``nn_mfu_vs_bf16_peak``
(against a TPU v5e) is not carried over, nor are its TPU anchors:
``vs_baseline`` is null unless ``BENCH_ANCHOR_STEPS_PER_S`` is set.  A run
on the CPU (``BENCH_DEVICE=cpu``, a rehearsal) gets a metric name ending
in ``_cpu``.

Env knobs: BENCH_GAME, BENCH_GAMES, BENCH_ROLLOUTS, BENCH_BF16,
BENCH_ROUNDS, BENCH_CHUNK, BENCH_SUPERBLOCK (-1: one lockstep batch),
BENCH_ANCHOR_STEPS_PER_S, BENCH_DEVICE (default cuda).
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time
from functools import partial

import numpy as np
import torch

from . import graphs, resolve_device
from .buffer import create_buffer
from .games import make_game
from .games.kernels import rules_owed
from .mcts import kernels as K
from .nets import MLP, apply_inference, config_for_game
from .profile_generation import card_line
from .mcts.tree import stat_dtype_for
from .selfplay import SelfplayConfig, make_carry, selfplay_continuous

BUFFER_CAPACITY = 2_000_000
CPUCT = 1.5
REPEATS = 3
SUPERBLOCK_LANES = 8192
# published dense peaks of one H100 SXM (NVIDIA's data sheet), by whether
# the tower runs in bfloat16; the MLP's float32 matmuls run without TF32
PEAKS = {
    False: (67e12, "H100 SXM float32 outside the tensor cores"),
    True: (989e12, "H100 SXM bfloat16 tensor cores, dense"),
}
ENGINE_SWITCHES = ("ALPHATPU_PACK", "ALPHATPU_NO_PACK")
WALK_OF_LEVEL = {0: "select_apply", 1: "select_apply_packed",
                 2: "select_apply_packed1"}


def schedule(game, games: int, rounds: int = 0, chunk: int = 0,
             superblock: int = 0):
    """bench.py's rules: ``(rounds, chunk, n_chunks, superblock lanes,
    superblocks)``.  ``n_chunks * chunk`` rounds are played."""
    rounds = rounds or max(168, 2 * game.max_game_length)
    chunk = chunk or rounds
    n_chunks = -(-rounds // chunk)
    if superblock == 0 and games > SUPERBLOCK_LANES \
            and games % SUPERBLOCK_LANES == 0:
        superblock = SUPERBLOCK_LANES
    sb = superblock if superblock > 0 and games % superblock == 0 else games
    return rounds, chunk, n_chunks, sb, games // sb


def owed_launches(game, pack_level: int, rollouts: int, rounds_played: int,
                  superblocks: int) -> dict:
    """Kernel launches one generation of ``game`` owes, per wrapper: each
    round of each superblock searches ``rollouts`` walks of its level's
    kernel and one ``backup`` flush, and runs the game's rules once a
    rollout and once for the move it plays."""
    if pack_level not in WALK_OF_LEVEL:
        raise ValueError(f"pack_level {pack_level}: the bench runs level 0, "
                         "1 or 2")
    rounds = rounds_played * superblocks
    owed = {k.__name__: 0 for k in K.KERNELS}
    owed.update(rules_owed(game, (rollouts + 1) * rounds))
    owed[WALK_OF_LEVEL[pack_level]] = rollouts * rounds
    owed["backup"] = rounds
    return owed


def superblock_generator(seed: int, s: int, device) -> torch.Generator:
    """Superblock ``s``'s selfplay stream: a generator on ``device`` seeded
    from ``(seed, s)`` on the host (the counterpart of ``fold_in(key, s)``)."""
    child = np.random.SeedSequence([seed, s]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(child) >> 1)


def generation(game, net_apply, buffer, cfg: SelfplayConfig, seed: int,
               n_sb: int, n_chunks: int, uniforms=None,
               captured: bool | None = None) -> dict:
    """One generation over all lanes: ``n_sb`` superblocks of
    ``cfg.num_games`` lanes one after another, each ``n_chunks`` chained
    ``selfplay_continuous`` calls of ``cfg.rounds`` rounds with a carry of
    its own; rows go to ``buffer`` (in place).

    Returns the stats summed as bench.py sums them (0-d tensors):
    ``length_sum`` (recovered as ``mean_length * games_finished`` per call)
    in place of ``mean_length``, and ``carried`` the sum of each
    superblock's last snapshot.  ``uniforms(s, c)`` gives superblock ``s``'s
    chunk ``c`` its draws (:class:`~alphatpu_torch.selfplay.SelfplayUniforms`)
    - the tests' injection point.  ``captured``: as
    :func:`~alphatpu_torch.selfplay.selfplay_continuous` takes it (by
    default the rounds replay CUDA graphs on the card)."""
    dev = buffer.state.device
    totals, carried = None, 0
    for s in range(n_sb):
        carry = make_carry(game, cfg.num_games,
                           superblock_generator(seed, s, dev), dev)
        for c in range(n_chunks):
            _, stats, carry = selfplay_continuous(
                game, net_apply, buffer, None, cfg, carry,
                uniforms=None if uniforms is None else uniforms(s, c),
                captured=captured)
            stats["length_sum"] = stats.pop("mean_length") * stats[
                "games_finished"]
            sb_carried = stats.pop("carried")  # a snapshot, not additive
            totals = stats if totals is None else {
                k: totals[k] + v for k, v in stats.items()}
        carried = carried + sb_carried
    totals["carried"] = carried
    return totals


@contextlib.contextmanager
def _pinned_engine(level: int):
    """The engine switches set for ``level``; the caller's restored after."""
    saved = {k: os.environ.get(k) for k in ENGINE_SWITCHES}
    for k in ENGINE_SWITCHES:
        os.environ.pop(k, None)
    if level:
        os.environ["ALPHATPU_PACK"] = str(level)
    else:
        os.environ["ALPHATPU_NO_PACK"] = "1"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _device_info(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"type": "cpu", "name": "cpu", "count": 0, "nvidia_smi": None}
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "nvidia_smi": card_line()}


def measure(game_name="connect4", games=8192, rollouts=64, bf16=False,
            rounds=0, seed=0, chunk=0, superblock=0, pack_level=1,
            device="cuda", captured: bool | None = None):
    """Three timed continuous-selfplay generations after a warm-up; returns
    the result dict (module doc).  ``pack_level`` 0, 1 or 2 picks the
    engine; bf16 stats (``ALPHATPU_BF16_STATS``) run level 0 whatever it
    says.  ``device="cuda"`` raises where torch finds no card; a kernel
    that fails to build or launch raises too.  ``captured`` (default: on
    the card) replays every round from a CUDA graph, captured in the
    warm-up; ``captured=False`` runs the rounds eagerly."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    captured = graphs.use_graphs(captured, dev)
    stat_dtype = stat_dtype_for(rollouts)
    bf16_stats = stat_dtype == torch.bfloat16
    if bf16_stats:
        pack_level = 0
    game = make_game(game_name)
    rounds, chunk, n_chunks, sb, n_sb = schedule(game, games, rounds, chunk,
                                                 superblock)
    rounds_played = n_chunks * chunk
    owed = owed_launches(game, pack_level, rollouts, rounds_played, n_sb)
    net_cfg = config_for_game(game)
    net = MLP.from_seed(net_cfg, seed, device=dev)
    n_params = sum(p.numel() for p in net.parameters())
    apply = (partial(apply_inference, compute_dtype=torch.bfloat16)
             if bf16 else apply_inference)
    net_apply = partial(apply, net)
    cfg = SelfplayConfig(num_games=sb, rollouts=rollouts, cpuct=CPUCT,
                         continuous=True, rounds=chunk)
    buf = create_buffer(game, BUFFER_CAPACITY, device=dev)

    def run(gen_seed):
        # every generation starts from the same empty buffer, as bench.py's
        buf.cursor.zero_()
        buf.total.zero_()
        if cuda:
            torch.cuda.synchronize(dev)
        K.reset_launch_counts()
        graphs.reset_counts()
        t0 = time.perf_counter()
        stats = generation(game, net_apply, buf, cfg, gen_seed, n_sb,
                           n_chunks, captured=captured)
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counted = {k.__name__: k.launches for k in K.KERNELS}
        if cuda and counted != owed:
            raise RuntimeError(f"launches {counted}, owed {owed}")
        return (wall, {k: v.item() for k, v in stats.items()}, counted,
                dict(graphs.counts))

    with _pinned_engine(pack_level):
        # warm-up: builds the kernels and captures the round, excluded
        # from timing
        warm = run(seed + 1)[3]
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        reps = [run(seed + 2) for _ in range(REPEATS)]
    peak_mem = torch.cuda.max_memory_allocated(dev) if cuda else None

    walls = [w for w, _, _, _ in reps]
    for key in ("samples_written", "carried"):
        seen = [st[key] for _, st, _, _ in reps]
        if len(set(seen)) != 1:
            raise RuntimeError(f"repeats differ in {key}: {seen} (identical "
                               "seeds must give identical work)")
    stats, counted, replayed = reps[0][1], reps[-1][2], reps[-1][3]
    illegal = sum(int(st["illegal_moves"]) for _, st, _, _ in reps)
    if illegal:
        raise RuntimeError(f"{illegal} illegal moves in the timed runs")
    dt = statistics.median(walls)
    mean_length = stats["length_sum"] / max(float(stats["games_finished"]),
                                            1.0)
    env_steps = float(stats["samples_written"]) + float(stats["carried"])
    steps_per_s = env_steps / dt
    rollouts_per_s = steps_per_s * rollouts
    peak, peak_name = PEAKS[bool(bf16)]
    # each rollout evaluates the net once per lane: 2 * params flops
    mfu = rollouts_per_s * 2 * n_params / peak if cuda else None

    metric = (f"torch_selfplay_env_steps_per_s_{game_name}_g{games}"
              f"_r{rollouts}" + ("_bf16" if bf16 else "")
              + ("_bf16stats" if bf16_stats else
                 f"_l{pack_level}" if pack_level != 1 else "")
              + ("" if cuda else "_cpu"))
    return {
        "metric": metric,
        "value": round(steps_per_s, 1),
        "unit": "env-steps/s",
        "vs_baseline": None,
        "anchor": "none: no committed anchor on this card",
        "extra": {
            "env_steps": int(env_steps),
            "samples_written": int(stats["samples_written"]),
            "carried": int(stats["carried"]),
            "wall_s": round(dt, 2),
            "wall_s_all": walls,
            "spread": (max(walls) - min(walls)) / dt,
            "rollouts_per_s": round(rollouts_per_s, 1),
            "games": games,
            "rollouts": rollouts,
            "net": f"{net_cfg.depth}x{net_cfg.width}",
            "params": n_params,
            "nn_mfu": mfu,
            "peak_flops": peak if cuda else None,
            "peak": peak_name if cuda else None,
            "mean_game_length": round(float(mean_length), 2),
            "bf16_inference": bool(bf16),
            "illegal_moves": illegal,
            "rounds": rounds,
            "rounds_played": rounds_played,
            "chunk_rounds": chunk,
            "superblock_lanes": sb,
            "superblocks": n_sb,
            "pack_level": pack_level,
            "stat_dtype": str(stat_dtype).removeprefix("torch."),
            "launches": counted,
            "launches_owed": owed,
            "captured": captured,
            "graph_replays": replayed["replays"],
            "graph_captures": replayed["captures"],
            "warmup_graph_captures": warm["captures"],
            "capture_s": warm["capture_s"],
            "graph_nodes": warm["capture_nodes"],
            "graph_pool_bytes": warm["capture_pool_bytes"],
            "peak_mem_bytes": peak_mem,
            "device": _device_info(dev),
        },
    }


def main() -> int:
    env = os.environ.get
    result = measure(
        env("BENCH_GAME", "connect4"),
        games=int(env("BENCH_GAMES", 8192)),
        rollouts=int(env("BENCH_ROLLOUTS", 64)),
        bf16=env("BENCH_BF16", "") not in ("", "0"),
        rounds=int(env("BENCH_ROUNDS", 0)),
        chunk=int(env("BENCH_CHUNK", 0)),
        superblock=int(env("BENCH_SUPERBLOCK", 0)),
        device=env("BENCH_DEVICE", "cuda"))
    anchor = env("BENCH_ANCHOR_STEPS_PER_S")
    if anchor:
        result["vs_baseline"] = round(result["value"] / float(anchor), 3)
        result["anchor"] = f"BENCH_ANCHOR_STEPS_PER_S={anchor}"
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
