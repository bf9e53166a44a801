"""Command-line entry point of the port.

Counterpart of :mod:`alphatpu.cli`: the same flags with the same names and
defaults, plus ``--device`` (default ``cuda``; ``--device cpu`` runs every
kernel's plain torch version on the CPU).  Without CUDA and without
``--device cpu`` the run stops with an error: it never moves to the CPU by
itself.  ``--profile-dir`` traces the first generation with
``torch.profiler`` (a Chrome trace in that directory; rank 0's in a world
of several).

Data-parallel training, one process per rank (:mod:`alphatpu_torch.
parallel`): ``--devices D`` spawns D ranks on this host, one card each
(``nccl``) or, under ``--device cpu``, D CPU processes (``gloo``), joined
at a free ``tcp://localhost`` port; ``--devices 0`` takes every visible
card.  ``--multihost`` makes this process one rank of a world spread over
hosts: ``--coordinator host:port``, ``--num-processes`` and
``--process-id``, or torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; each process drives one card.
Without ``--multihost`` its three companions are ignored, as the
reference ignores them.

Usage:
    python -m alphatpu_torch.cli --game connect4 --samples 32768 \\
        --rollout 64 --generation 100 --batchsize 8192 --cpuct 1.5
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alphatpu_torch",
        description="AlphaZero training on one NVIDIA GPU (PyTorch / CUDA)")
    p.add_argument("--game", default="connect4",
                   help="tictactoe | connect4 | gobang<N> | hex<N> | "
                        "reversi6x6 | reversi8x8")
    p.add_argument("--samples", type=int, default=None,
                   help="selfplay games per generation (default: 16384 for "
                        "reversi8x8, else 32768)")
    p.add_argument("--rollout", type=int, default=64,
                   help="MCTS rollouts per move")
    p.add_argument("--generation", type=int, default=100,
                   help="number of generations")
    p.add_argument("--batchsize", type=int, default=2 * 4096,
                   help="SGD batch size")
    p.add_argument("--cpuct", type=float, default=1.5,
                   help="exploration coefficient")
    p.add_argument("--noise", type=float, default=None,
                   help="accepted for parity with the reference's flags and "
                        "ignored: the root mix is the fixed 0.75/0.25")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--depth", type=int, default=None,
                   help="residual tower depth (default: per game)")
    p.add_argument("--buffer-capacity", type=int, default=2_000_000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--feature-weight", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--duel-games", type=int, default=1024)
    p.add_argument("--duel-rollouts", type=int, default=32)
    p.add_argument("--continuous", action="store_true",
                   help="continuous selfplay: --samples lanes play "
                        "back-to-back games for --rounds move rounds")
    p.add_argument("--rounds", type=int, default=None,
                   help="move rounds per lane in --continuous mode "
                        "(default 2x the game's max length)")
    p.add_argument("--bf16-inference", action="store_true",
                   help="evaluate the in-search net's tower in bfloat16 "
                        "(training stays float32)")
    p.add_argument("--fresh-root-policy", action="store_true",
                   help="recompute the root policy after the final backup "
                        "instead of returning the last pre-backup policy")
    p.add_argument("--temp-moves", type=int, default=25)
    p.add_argument("--duel-temp-moves", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default Data<game>/)")
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--save-buffer", action="store_true",
                   help="include the replay buffer in checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --ckpt-dir")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel ranks, one process and one card "
                        "each (CPU processes under --device cpu): selfplay "
                        "lanes, buffer, learner and duels shard over them "
                        "(0 = every visible card, 1 = single-device path)")
    p.add_argument("--multihost", action="store_true",
                   help="this process is one rank of a world over hosts, "
                        "one card per process: give --coordinator, "
                        "--num-processes and --process-id, or run under "
                        "torchrun")
    p.add_argument("--coordinator", default=None,
                   help="with --multihost: rank 0's address host:port "
                        "(default: torchrun's MASTER_ADDR/MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --multihost: the world size (default: "
                        "WORLD_SIZE)")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --multihost: this process's rank (default: "
                        "RANK)")
    p.add_argument("--stats-file", default=None,
                   help="append per-generation stats as JSON lines")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first "
                        "generation into this directory")
    p.add_argument("--device", default="cuda",
                   help="the torch device to train on: cuda (default), "
                        "cuda:<n> or cpu")
    return p


def default_samples(game_name: str) -> int:
    """The reference's per-game --samples default: 16384 for Reversi 8x8,
    32768 everywhere else."""
    return 16384 if game_name == "reversi8x8" else 32768


class WorldPlan(NamedTuple):
    """The world the flags ask for, before any process joins it."""

    size: int
    rank: int | None  # None: spawn ranks 0..size-1 on this host
    init_method: str | None
    backend: str | None


def resolve_world(args, env=None) -> WorldPlan:
    """The world of ``args``' ``--devices``, ``--multihost`` and its
    companions (``env``: default ``os.environ``, for torchrun's
    variables).  Raises ``ValueError`` where the flags ask for more cards
    than are visible or leave a multi-host world undefined."""
    import torch

    from .parallel.mesh import (
        default_backend, free_init_method, world_devices,
    )

    env = os.environ if env is None else env
    if args.multihost:
        size = (args.num_processes if args.num_processes is not None
                else env.get("WORLD_SIZE"))
        rank = (args.process_id if args.process_id is not None
                else env.get("RANK"))
        init = (f"tcp://{args.coordinator}" if args.coordinator else
                "env://" if "MASTER_ADDR" in env else None)
        if size is None or rank is None or init is None:
            raise ValueError(
                "--multihost needs --coordinator, --num-processes and "
                "--process-id, or torchrun's MASTER_ADDR, MASTER_PORT, "
                "WORLD_SIZE and RANK")
        size = int(size)
        if args.devices not in (0, 1, size):
            raise ValueError(f"--devices {args.devices} with --multihost: "
                             f"the world has {size} processes, one card "
                             f"each; pass --devices 0")
        return WorldPlan(size, int(rank), init, default_backend(args.device))
    size = world_devices(args.devices, args.device)
    if size == 1:
        return WorldPlan(1, 0, None, None)
    if torch.device(args.device).index is not None:
        raise ValueError(f"--devices {size} on the one card --device "
                         f"{args.device}: each rank needs a card of its own; "
                         "pass --device cuda")
    return WorldPlan(size, None, free_init_method(),
                     default_backend(args.device))


def make_pipeline_config(args, game, world=None):
    """The pipeline's configuration from the flags; with ``world`` (a
    :class:`~alphatpu_torch.parallel.World`) on its size and the rank's
    device."""
    from functools import partial

    import torch

    from .duel import DuelConfig
    from .nets import apply_inference
    from .pipeline import PipelineConfig
    from .selfplay import SelfplayConfig
    from .train import TrainConfig

    net_apply = (partial(apply_inference, compute_dtype=torch.bfloat16)
                 if args.bf16_inference else apply_inference)
    return PipelineConfig(
        selfplay=SelfplayConfig(
            num_games=args.samples or default_samples(args.game),
            rollouts=args.rollout,
            cpuct=args.cpuct,
            temp_moves=args.temp_moves,
            continuous=args.continuous,
            rounds=args.rounds,
            fresh_root_policy=args.fresh_root_policy,
        ),
        train=TrainConfig(
            batch_size=args.batchsize,
            lr=args.lr,
            weight_decay=args.weight_decay,
            feature_weight=args.feature_weight,
            epochs=args.epochs,
        ),
        duel=DuelConfig(
            num_games=args.duel_games,
            rollouts=args.duel_rollouts,
            temp_moves=args.duel_temp_moves,
        ),
        buffer_capacity=args.buffer_capacity,
        generations=args.generation,
        seed=args.seed,
        width=args.width,
        depth=args.depth,
        ckpt_dir=None if args.no_checkpoint else (
            args.ckpt_dir or f"Data{args.game}"),
        save_buffer=args.save_buffer,
        net_apply=net_apply,
        devices=args.devices if world is None else world.size,
        device=args.device if world is None else str(world.device),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    plan = resolve_world(args)
    from .parallel.mesh import make_world, run_ranks

    if plan.rank is None:
        run_ranks(train, plan.size, args, device=args.device,
                  backend=plan.backend, init_method=plan.init_method)
        return 0
    world = make_world(plan.size, args.device, rank=plan.rank,
                       backend=plan.backend, init_method=plan.init_method)
    import torch.distributed as dist

    try:
        return train(world, args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train(world, args) -> int:
    """The run of ``args`` on this process's rank of ``world``: rank 0
    logs, writes the checkpoints and appends the stats file."""
    import torch

    from .games import make_game
    from .pipeline import init_pipeline, resume, run_generation

    device = world.device
    game = make_game(args.game)
    cfg = make_pipeline_config(args, game, world)
    lead = world.rank == 0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    D = world.size
    print(f"alphatpu_torch: game={game.name} device={device} ({name})"
          + (f" rank {world.rank}  (dp mesh over {D})" if D > 1 else ""),
          flush=True)
    state = init_pipeline(game, cfg)

    if args.resume and cfg.ckpt_dir and os.path.exists(
            os.path.join(cfg.ckpt_dir, "latest.json")):
        resume(game, state, cfg)
        if lead:
            print(f"resumed at generation {state.generation}, "
                  f"elo {state.elo:.1f}")

    t0 = time.time()
    first_gen = True
    while state.generation < cfg.generations:
        if args.profile_dir and first_gen and lead:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=activities) as prof:
                state, stats = run_generation(game, state, cfg)
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                args.profile_dir, f"generation{state.generation}.json"))
            print(f"profiler trace written to {args.profile_dir}")
        else:
            state, stats = run_generation(game, state, cfg)
        first_gen = False
        if args.stats_file and lead:
            with open(args.stats_file, "a") as f:
                f.write(json.dumps(stats, default=float) + "\n")
    print(f"done: {cfg.generations} generations in {time.time() - t0:.0f}s; "
          f"best generation {state.best_generation}, elo {state.elo:.1f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
