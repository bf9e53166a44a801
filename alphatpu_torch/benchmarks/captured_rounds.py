"""Captured rounds against eager rounds, in turns, on one card.

    python -m alphatpu_torch.benchmarks.captured_rounds [--full] \\
        [--out captured.json]

The same work run eagerly (``captured=False``) and from CUDA graphs (the
default on the card, :mod:`alphatpu_torch.graphs`), in the order eager,
captured, captured, eager, so that a drift of the card or its host shows
in both:

* the bench's ``measure`` (connect4, 4x512, 8192 lanes, 64 rollouts,
  continuous, level 1) at 8 rounds in chunks of 4: env-steps/s, walls,
  peak device memory, and for the captured runs the capture's seconds,
  graph nodes and graph-pool bytes (each ``measure`` captures in its
  warm-up and replays every timed round);
* with ``--full``, the bench's own 168 rounds, captured then eager;
* a duel half (connect4, 4x512, 512 lanes, 32 rollouts, 42 rounds): the
  first captured call captures a graph per net, the second replays only.

One JSON line per run, each with the card's name and power limit
(``nvidia-smi``); ``--out`` writes them all.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import bench, graphs, resolve_device
from ..duel import DuelConfig, duel_half
from ..games import make_game
from ..nets import MLP, config_for_game
from ..profile_generation import card_line

LANES, ROLLOUTS = 8192, 64
CUT_ROUNDS, CUT_CHUNK = 8, 4
DUEL = DuelConfig(num_games=512, rollouts=32)
ORDER = (False, True, True, False)  # eager, captured, captured, eager


def bench_run(captured: bool, rounds: int, chunk: int, card: str) -> dict:
    r = bench.measure("connect4", games=LANES, rollouts=ROLLOUTS,
                      rounds=rounds, chunk=chunk, device="cuda",
                      captured=captured)
    ex = r["extra"]
    keep = ("wall_s", "wall_s_all", "spread", "env_steps", "peak_mem_bytes",
            "graph_replays", "graph_captures", "warmup_graph_captures",
            "capture_s", "graph_nodes", "graph_pool_bytes", "launches")
    return {"run": "bench", "captured": captured, "rounds": rounds,
            "chunk": chunk, "env_steps_per_s": r["value"],
            **{k: ex[k] for k in keep}, "card": card}


def duel_run(game, nets, captured: bool, card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    graphs.reset_counts()
    t0 = time.perf_counter()
    tally = duel_half(game, *nets, gen, DUEL, "cuda", captured=captured)
    torch.cuda.synchronize()
    return {"run": "duel half", "captured": captured,
            "games": DUEL.num_games, "rollouts": DUEL.rollouts,
            "rounds": game.max_game_length,
            "seconds": time.perf_counter() - t0,
            "tally": [int(x) for x in tally], **graphs.counts, "card": card}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true",
                   help="also the bench's 168 rounds, captured then eager")
    p.add_argument("--out", default=None, help="write the runs as JSON")
    args = p.parse_args(argv)
    resolve_device("cuda")
    card = card_line()
    print(card)
    runs = []

    def show(rec):
        runs.append(rec)
        print(json.dumps(rec), flush=True)

    for captured in ORDER:
        show(bench_run(captured, CUT_ROUNDS, CUT_CHUNK, card))
    if args.full:
        for captured in (True, False):
            show(bench_run(captured, 0, 0, card))
    graphs.clear_cache()
    game = make_game("connect4")
    nets = tuple(MLP.from_seed(config_for_game(game), s, device="cuda")
                 for s in (0, 1))
    for captured in ORDER:
        show(duel_run(game, nets, captured, card))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
