"""Time a probe's moves in the games a net plays against it.

    python -m alphatpu_torch.benchmarks.probe_moves --game gobang13 \\
        --ckpt net56.npz --games 8 --out moves.json

Plays :func:`~alphatpu_torch.probe.eval_vs_probe` with the reference's
protocol (``--rollout`` 64, 8 sampled plies, seed 0) against the game's
probe, whose every ``best_action`` is timed on the host, and projects a
probe run of ``PROJECT_GAMES`` games (gobang13's record): games x the
probe's moves a game x the mean seconds a move (``eval_vs_probe`` plays
the probe's moves one after another).  The net is a checkpoint's best
net, or ``MLP.from_seed(0)`` at the game's reference size without
``--ckpt``.  The timing leaves every action as it is.  Prints one JSON
line, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import time

import numpy as np
import torch

from .. import resolve_device
from ..games import make_game
from ..nets import MLP, config_for_game, params_from_jax
from ..probe import eval_vs_probe, probe_for_game
from .train_record import card_line

PROJECT_GAMES = 32


class TimedProbe:
    """A probe whose ``best_action`` calls are timed: ``moves`` holds (the
    stones on the board, seconds) for each."""

    def __init__(self, probe):
        self.probe = probe
        self.depth = probe.depth
        self.moves: list[tuple[int, float]] = []

    def best_action(self, mover, other, rng):
        t = time.perf_counter()
        a = self.probe.best_action(mover, other, rng)
        self.moves.append((int(mover.sum() + other.sum()),
                           time.perf_counter() - t))
        return a


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="alphatpu_torch.benchmarks.probe_moves",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--game", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="net<N>.npz (its best net); default MLP.from_seed(0)")
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--games", type=int, default=4)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    game = make_game(args.game)
    cfg = config_for_game(game)
    if args.ckpt:
        with np.load(args.ckpt) as z:
            net = params_from_jax(dict(z), cfg, device=dev, prefix="best/")
    else:
        net = MLP.from_seed(cfg, 0, device=dev)
    probe = TimedProbe(probe_for_game(game, args.depth))
    t0 = time.perf_counter()
    w, d, l = eval_vs_probe(
        game, net, torch.Generator(device=dev).manual_seed(0), probe,
        num_games=args.games, rollouts=args.rollout, device=dev)
    wall = time.perf_counter() - t0
    secs = np.array([s for _, s in probe.moves])
    a_game = len(secs) / args.games
    out = {
        "game": game.name, "probe": type(probe.probe).__name__,
        "probe_depth": probe.depth,
        "net": args.ckpt or "MLP.from_seed(0)", "games": args.games,
        "rollouts": args.rollout,
        "net_wins": w, "draws": d, "net_losses": l,
        "probe_moves": len(secs), "probe_moves_a_game": a_game,
        "seconds_a_move": {"mean": float(secs.mean()),
                           "median": float(np.median(secs)),
                           "max": float(secs.max())},
        "probe_seconds": float(secs.sum()), "wall": wall,
        "projected_probe_seconds": float(PROJECT_GAMES * a_game
                                         * secs.mean()),
        "host": {"cpus": os.cpu_count(), "machine": platform.machine()},
        "card": card_line() if dev.type == "cuda" else None,
        "moves": [[n, round(s, 6)] for n, s in probe.moves],
    }
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
