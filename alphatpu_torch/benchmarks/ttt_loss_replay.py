"""Replay a tictactoe checkpoint's probe games and attribute every loss.

    python -m alphatpu_torch.benchmarks.ttt_loss_replay [ckpt] [temp_moves] \\
        [seed] [--device cpu]

Counterpart of ``benchmarks/ttt_loss_replay.py``.  It reruns
``eval_vs_probe`` with ``trace=True`` (the probe protocol: the net against
the perfect player, sampling for the first ``temp_moves`` plies, greedy
after), finds each lost game, and for every net move of that game asks an
exact tictactoe negamax oracle (:func:`solve`, a copy of the reference's):

* was the position already lost before the move?
* if not, did this move throw the game (the value drops to lost)?
* if it did: was it a sampled pick of the temperature phase that differs
  from the greedy pick, and would the greedy pick have kept the value?

Verdict per loss: ``sampling_induced`` (the blunder was a sampled pick
other than the greedy one, and the greedy pick kept the draw or win) or
not (the greedy pick itself blunders, or a greedy-phase move did).  One
JSON object on stdout.  The checkpoint is a ``net<N>.npz`` of either
package (its ``best/`` weights at tictactoe's reference size); the net
searches on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

# the 8 tictactoe lines hold in action-index space under either r+3c or
# c+3r cell numbering (transposition maps the set onto itself)
LINES = [(0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7), (2, 5, 8),
         (0, 4, 8), (2, 4, 6)]
LINE_MASKS = [sum(1 << a for a in t) for t in LINES]
FULL = (1 << 9) - 1


@functools.lru_cache(maxsize=None)
def solve(me: int, opp: int) -> int:
    """Exact negamax value for the side to move: +1 win, 0 draw, -1 loss.
    (me, opp) are 9-bit occupancy masks in action-index space; the
    previous mover is ``opp``, so a completed opp line means loss."""
    if any((opp & m) == m for m in LINE_MASKS):
        return -1
    if (me | opp) == FULL:
        return 0
    best = -1
    for a in range(9):
        b = 1 << a
        if (me | opp) & b:
            continue
        best = max(best, -solve(opp, me | b))
        if best == 1:
            return 1
    return best


def attribute(i: int, records) -> dict:
    """The verdict on lost game ``i`` of an ``eval_vs_probe`` trace: its
    first net move from a position not yet lost into a lost one."""
    me = opp = 0  # occupancy from the side to move's perspective
    verdict = None
    for rec in records:
        if not rec["alive"][i]:
            break
        a = int(rec["action"][i])
        if rec["net_turn"][i]:
            v_before = solve(me, opp)
            v_after = -solve(opp, me | (1 << a))
            if v_before >= 0 and v_after == -1 and verdict is None:
                g = int(rec["greedy"][i])
                v_greedy = -solve(opp, me | (1 << g))
                verdict = {
                    "lane": int(i),
                    "blunder_ply": rec["ply"],
                    "sampling_phase": bool(rec["sampling_phase"]),
                    "played": a,
                    "greedy": g,
                    "played_was_sampled_nongreedy": bool(
                        rec["sampling_phase"] and a != g),
                    "value_before": v_before,
                    "value_after_played": v_after,
                    "value_after_greedy": v_greedy,
                    "greedy_preserves": bool(v_greedy >= 0),
                }
        me, opp = opp, me | (1 << a)
    if verdict is None:
        return {"lane": int(i),
                "note": "no net blunder ply found (lost from the start of a "
                        "net-second game?)"}
    verdict["sampling_induced"] = bool(
        verdict["played_was_sampled_nongreedy"]
        and verdict["greedy_preserves"])
    return verdict


def analyze(ckpt="Datatictactoe/net80.npz", temp_moves=8, seed=0,
            games=64, rollouts=64, device="cuda", uniforms=None,
            quiet=False) -> dict:
    """The probe run of ``ckpt`` and the verdict on each loss (module
    doc); prints it as JSON unless ``quiet``.  The search draws from a
    generator seeded ``seed`` on ``device``, or from ``uniforms`` (a
    :class:`~alphatpu_torch.selfplay.SelfplayUniforms`, the tests'
    injection point)."""
    from .. import resolve_device
    from ..games import make_game
    from ..nets import config_for_game, params_from_jax
    from ..probe import eval_vs_probe, probe_for_game

    dev = resolve_device(device)
    game = make_game("tictactoe")
    with np.load(ckpt) as z:
        net = params_from_jax(dict(z), config_for_game(game), device=dev,
                              prefix="best/")
    w, d, l, tr = eval_vs_probe(
        game, net, torch.Generator(device=dev).manual_seed(seed),
        probe_for_game(game), num_games=games, rollouts=rollouts,
        temp_moves=temp_moves, seed=seed, trace=True, device=dev,
        uniforms=uniforms)
    lost = np.where(tr["result"] == -tr["net_sign"])[0]
    out = {"ckpt": ckpt, "temp_moves": temp_moves, "seed": seed,
           "score": [w, d, l],
           "losses": [attribute(i, tr["records"]) for i in lost]}
    if not quiet:
        print(json.dumps(out, indent=1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="alphatpu_torch.benchmarks."
                                      "ttt_loss_replay",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", nargs="?", default="Datatictactoe/net80.npz")
    ap.add_argument("temp_moves", nargs="?", type=int, default=8)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the torch device the net searches on: cuda "
                         "(default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    analyze(args.ckpt, args.temp_moves, args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
