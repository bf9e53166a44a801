"""Command-line entry point of the port.

Counterpart of :mod:`alphatpu.cli`: the same flags with the same names and
defaults, plus ``--device`` (default ``cuda``; ``--device cpu`` runs every
kernel's plain torch version on the CPU).  Without CUDA and without
``--device cpu`` the run stops with an error: it never moves to the CPU by
itself.  ``--devices`` other than 1 and ``--multihost`` (with its three
companions) raise ``NotImplementedError``: multi-GPU training is not ported
yet (ROADMAP.md, queue 1, item 11).  ``--profile-dir`` traces the first
generation with ``torch.profiler`` (a Chrome trace in that directory).

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
                   help="devices to train on; only 1 is ported")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training; not ported")
    p.add_argument("--coordinator", default=None,
                   help="with --multihost; not ported")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --multihost; not ported")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --multihost; not ported")
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


def make_pipeline_config(args, game):
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
        devices=args.devices,
        device=args.device,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .pipeline import MULTI_GPU

    if args.multihost or args.coordinator or args.num_processes is not None \
            or args.process_id is not None or args.devices != 1:
        raise NotImplementedError(MULTI_GPU)

    import torch

    from . import resolve_device

    device = resolve_device(args.device)

    from .games import make_game
    from .pipeline import init_pipeline, resume, run_generation

    game = make_game(args.game)
    cfg = make_pipeline_config(args, game)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"alphatpu_torch: game={game.name} device={device} ({name})")
    state = init_pipeline(game, cfg)

    if args.resume and cfg.ckpt_dir and os.path.exists(
            os.path.join(cfg.ckpt_dir, "latest.json")):
        resume(game, state, cfg)
        print(f"resumed at generation {state.generation}, elo {state.elo:.1f}")

    t0 = time.time()
    first_gen = True
    while state.generation < cfg.generations:
        if args.profile_dir and first_gen:
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
        if args.stats_file:
            with open(args.stats_file, "a") as f:
                f.write(json.dumps(stats, default=float) + "\n")
    print(f"done: {cfg.generations} generations in {time.time() - t0:.0f}s; "
          f"best generation {state.best_generation}, elo {state.elo:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
