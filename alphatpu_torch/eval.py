"""Strength evaluation utilities.

Counterpart of :mod:`alphatpu.eval`:

* :func:`eval_vs_random` - batched games of the candidate (full MCTS,
  greedy) against a uniform-random legal mover; the cheapest
  absolute-strength floor.  A game still running at the move bound counts
  as a draw.
* :func:`ladder` - round-robin duels between checkpoints through
  :func:`~alphatpu_torch.duel.duel_network`, which leaves unfinished games
  out of its tally.

Both run on ``device``, the card unless the caller asks for the CPU; they
never move to the CPU by themselves
(:func:`alphatpu_torch.resolve_device`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import resolve_device
from .duel import DuelConfig, duel_network
from .games.base import where_games
from .mcts.newton import cdf_sample
from .mcts.search import run_mcts
from .mcts.tree import init_tree, reset_tree, stat_dtype_for
from .selfplay import SelfplayUniforms, broadcast_initial


class EvalConfig(NamedTuple):
    num_games: int = 256
    rollouts: int = 64
    cpuct: float = 1.5
    max_moves: int | None = None


def _vs_random_half(game, net, generator, positions0, cfg: EvalConfig,
                    net_first: bool, uniforms: SelfplayUniforms | None = None):
    """All games with the net moving first (or second), on the device of
    ``positions0``, for exactly ``T = cfg.max_moves or max_game_length``
    plies: the net searches every ply and a finished game's moves are
    masked.  The net plays greedily (diversity comes from the random
    mover).  Random numbers per ply: the search's uniforms, then one
    uniform per game for the random mover, from ``generator`` or from
    ``uniforms`` (``probs[t]``, ``move[t]``).  Returns (net_wins, draws,
    net_losses, unfinished) as 0-d tensors."""
    G = cfg.num_games
    T = cfg.max_moves or game.max_game_length
    dev = positions0.player.device
    positions = positions0
    tree = init_tree(game, positions, cfg.rollouts,
                     stat_dtype=stat_dtype_for(cfg.rollouts))
    done = torch.zeros((G,), dtype=torch.bool, device=dev)
    result = torch.zeros((G,), dtype=torch.int8, device=dev)
    for t in range(T):
        reset_tree(tree, positions)
        _, pol = run_mcts(
            game, net, tree, rollouts=cfg.rollouts, cpuct=cfg.cpuct,
            training=False, generator=generator,
            probs=None if uniforms is None else uniforms.probs[t])
        net_action = torch.argmax(pol, dim=0).to(torch.int32)
        legal = game.legal_mask(positions)  # [G, A]
        u = (torch.rand((G,), generator=generator, device=dev)
             if uniforms is None else uniforms.move[t])
        rnd_action = cdf_sample(legal.T.to(torch.float32), u * legal.sum(-1))
        action = net_action if (t % 2 == 0) == net_first else rnd_action
        alive = ~done
        positions = where_games(alive, game.play(positions, action),
                                positions)
        f, r = game.is_over(positions)
        result = torch.where(alive & f, r, result)
        done = done | f
    net_sign = 1 if net_first else -1
    return (((result == net_sign) & done).sum(),
            ((result == 0) & done).sum(),
            ((result == -net_sign) & done).sum(), (~done).sum())


def eval_vs_random(game, net, generator, cfg: EvalConfig = EvalConfig(),
                   device="cuda"):
    """(wins, draws, losses) for the net over ``num_games`` games vs a
    uniform-random legal mover, half starting each.  The rare game not
    finished at the move bound counts as a draw."""
    dev = resolve_device(device)
    half = cfg._replace(num_games=cfg.num_games // 2)
    positions0 = broadcast_initial(game, half.num_games, dev)
    w1, d1, l1, u1 = _vs_random_half(game, net, generator, positions0, half,
                                     True)
    w2, d2, l2, u2 = _vs_random_half(game, net, generator, positions0, half,
                                     False)
    return int(w1 + w2), int(d1 + d2 + u1 + u2), int(l1 + l2)


def ladder(game, checkpoints, generator, cfg: DuelConfig = DuelConfig(),
           device="cuda"):
    """Round-robin duels between ``checkpoints`` (a list of (name, net)).
    Returns a list of (name_a, name_b, wins_a, draws, wins_b)."""
    dev = resolve_device(device)
    out = []
    for i, (na, pa) in enumerate(checkpoints):
        for nb, pb in checkpoints[i + 1:]:
            w, d, l, _ = duel_network(game, pa, pb, generator, cfg, dev)
            out.append((na, nb, w, d, l))
    return out
