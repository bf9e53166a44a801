"""Ablation of the rollout body: how long a 64-rollout move takes with each
phase of the per-phase search left out.

    python -m alphatpu_torch.benchmarks.ablate_rollout

Counterpart of ``benchmarks/ablate_rollout.py``, over the port's per-phase
API (``search.select`` - the ``select`` kernel -, ``leaf_positions``, the
net, ``expand`` and ``search.backup`` - the ``backup`` kernel - once per
rollout).  Six variants: full, no-select (every game takes a random action
at its root), no-backup, no-nn (uniform prior, value 0.5), no-expand and
select-only.  A variant's move - its rollouts, the draws included - is
one program (:class:`AblationRounds`), as the reference jits it: on the
card it is captured in the warm-up move and replayed, so the time is the
device's work; ``captured=False`` runs it eagerly, host launches
included, and ``main`` prints both.  Each move starts from a fresh tree of
the initial positions (reset outside the timed window) and is timed on
the host clock up to a ``torch.cuda.synchronize``; the time is the mean
of ``n`` moves after one warm-up move.  On the card each variant's kernel
launches in the timed moves (replays add theirs) must be what
:func:`owed_launches` says.

Env knobs: GAME (default connect4), G (lanes, default 16384), R
(rollouts, default 64).  It runs on the card (:func:`ablate` takes a
``device``).
"""
from __future__ import annotations

import os
import sys
import time
from functools import partial
from typing import NamedTuple

import torch

from .. import graphs, resolve_device
from ..games import make_game
from ..games.kernels import rules_owed
from ..mcts import kernels as K
from ..mcts import search as S
from ..mcts.tree import init_tree, reset_tree
from ..nets import MLP, apply_inference, config_for_game
from ..profile_generation import card_line

CPUCT = 1.5


class Variant(NamedTuple):
    select: bool = True
    backup: bool = True
    nn: bool = True
    expand: bool = True


VARIANTS = {
    "full": Variant(),
    "no-select": Variant(select=False),
    "no-backup": Variant(backup=False),
    "no-nn": Variant(nn=False),
    "no-expand": Variant(expand=False),
    "select-only": Variant(backup=False, nn=False, expand=False),
}


def owed_launches(game, variant: Variant, rollouts: int, moves: int) -> dict:
    """Kernel launches of ``moves`` moves of ``game``: a ``select`` and a
    ``backup`` a rollout where the variant runs them, and the game's
    ``play`` and ``is_over`` once a rollout in every variant."""
    owed = {k.__name__: 0 for k in K.KERNELS}
    owed.update(rules_owed(game, rollouts * moves))
    owed["select"] = rollouts * moves * variant.select
    owed["backup"] = rollouts * moves * variant.backup
    return owed


def rollout(game, net, tree, probs, variant: Variant) -> None:
    """One rollout of every game, the phases ``variant`` keeps, in place."""
    G, A = tree.num_games, tree.num_actions
    dev = tree.device
    if variant.select:
        path, node, leaf_action, needs_alloc, _ = S.select(game, tree, probs,
                                                           CPUCT)
    else:
        node = torch.zeros((G,), dtype=torch.int32, device=dev)
        leaf_action = (probs[0] * A).to(torch.int32)
        needs_alloc = torch.ones((G,), dtype=torch.bool, device=dev)
        nodes = torch.zeros((probs.shape[0], G), dtype=torch.int32,
                            device=dev)
        nodes[1:] = -1
        path = S.Path(nodes, torch.zeros_like(nodes),
                      torch.ones((G,), dtype=torch.int32, device=dev))
    leaf_states = S.leaf_positions(game, tree, node, leaf_action, needs_alloc)
    if variant.nn:
        with torch.no_grad():
            logits, v = apply_inference(net, game.encode(leaf_states))
        prior = torch.softmax(logits, dim=-1).T.contiguous()
    else:
        prior = torch.full((A, G), 1.0 / A, device=dev)
        v = torch.full((G,), 0.5, device=dev)
    if variant.expand:
        _, done, result, _ = S.expand(game, tree, node, leaf_action,
                                      needs_alloc, leaf_states, prior, True)
    else:
        done, result = game.is_over(leaf_states)
    if variant.backup:
        S.backup(tree, path, leaf_states.player, v, done, result)


class AblationRounds(graphs.Rounds):
    """One variant's move as a program on the caller's ``tree``: its
    ``rollouts`` rollouts of every game, the draws included - the
    reference jits the ``scan`` of a variant's rollouts
    (``benchmarks/ablate_rollout.py:25-65``)."""

    def __init__(self, game, tree, rollouts: int, variant: Variant):
        super().__init__(tree.device)
        self.game, self.tree = game, tree
        self.rollouts, self.variant = rollouts, variant

    def round(self, net) -> None:
        tree = self.tree
        depth_cap = min(self.game.max_game_length, self.rollouts)
        for _ in range(self.rollouts):
            probs = torch.rand((depth_cap, tree.num_games),
                               generator=self.generator, device=self.device)
            rollout(self.game, net, tree, probs, self.variant)


def time_variant(game, net, tree, positions, generator, rollouts: int,
                 variant: Variant, moves: int = 5,
                 captured: bool | None = None):
    """``(ms per move, launches in the timed moves)`` of ``variant``: one
    warm-up move, then the mean of ``moves`` timed ones, each from the
    initial positions (reset outside the timed window) up to a
    synchronize.  ``captured`` (default: on a CUDA device) replays the
    move from a CUDA graph, captured in the warm-up; ``captured=False``
    runs it eagerly.  The tree is left as the last move left it."""
    dev = tree.device
    cuda = dev.type == "cuda"
    captured = graphs.use_graphs(captured, dev)
    st = AblationRounds(game, tree, rollouts, variant)

    def move():
        reset_tree(tree, positions)
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with graphs.drawing(st, generator, captured):
            graphs.step(st, "move", partial(st.round, net), captured)
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    move()  # warm-up (the kernels' build and, captured, the capture)
    K.reset_launch_counts()
    total = sum(move() for _ in range(moves))
    counted = {k.__name__: k.launches for k in K.KERNELS}
    owed = owed_launches(game, variant, rollouts, moves)
    if cuda and counted != owed:
        raise RuntimeError(f"launches {counted}, owed {owed}")
    return total / moves * 1e3, counted


def ablate(game_name="connect4", games=16384, rollouts=64, names=None,
           moves=5, device="cuda", log=print,
           captured: bool | None = None) -> dict:
    """Time the variants ``names`` (default all six) on ``games`` lanes,
    captured or eager as :func:`time_variant` takes ``captured``; returns
    ``{name: {"ms_per_move", "launches"}}`` (the launches of its timed
    moves) and logs a line per variant."""
    dev = resolve_device(device)
    mode = "captured" if graphs.use_graphs(captured, dev) else "eager"
    game = make_game(game_name)
    net = MLP.from_seed(config_for_game(game), 0, device=dev)
    positions = game.initial(games, dev)
    tree = init_tree(game, positions, rollouts)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name in names or VARIANTS:
        ms, counted = time_variant(game, net, tree, positions, gen,
                                   rollouts, VARIANTS[name], moves, captured)
        out[name] = {"ms_per_move": ms, "launches": counted}
        log(f"{name:12s} {mode:8s} {ms:8.1f} ms/move  "
            f"({ms / rollouts:.3f} ms/rollout)")
    return out


def main() -> int:
    env = os.environ.get
    resolve_device("cuda")  # no card: raise before printing anything
    game_name = env("GAME", "connect4")
    G, R = int(env("G", 16384)), int(env("R", 64))
    print(f"game={game_name} G={G} R={R} "
          f"A={make_game(game_name).max_actions} [{card_line()}]",
          flush=True)
    # captured (the reference's one program a move) beside eager
    for captured in (True, False):
        ablate(game_name, G, R, log=lambda line: print(line, flush=True),
               captured=captured)
    return 0


if __name__ == "__main__":
    sys.exit(main())
