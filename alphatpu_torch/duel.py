"""Arena: two-net duels with gating and incremental Elo.

Counterpart of :mod:`alphatpu.duel`: the actor is chosen by round parity
(``nets[t % 2]``; the module is picked, nothing is copied - on the card,
the graph captured of that net's round is replayed), each half of a
duel starts a different net, the search runs with ``training=False`` (no
root noise) and cpuct 2.0, and exactly ``T = max_moves or
max_game_length`` rounds are played.  A game still running at the bound is
counted ``unfinished`` and left out of the tally, not called a draw.

Random numbers come from a ``torch.Generator`` on the games' device, or
from pre-drawn :class:`~alphatpu_torch.selfplay.SelfplayUniforms` (one
``probs`` slice and one move uniform per round), the tests' injection
point.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from . import graphs
from .games.base import where_games
from .mcts.newton import cdf_sample, row_sum
from .mcts.search import run_mcts
from .mcts.tree import reset_tree
from .selfplay import SearchRounds, SelfplayUniforms


class DuelConfig(NamedTuple):
    num_games: int = 1024
    rollouts: int = 32
    cpuct: float = 2.0  # the reference's duel never takes the CLI's cpuct
    temp_moves: int = 15  # sample below this round, argmax after
    max_moves: int | None = None


class DuelRounds(SearchRounds):
    """The static state of :func:`duel_half`'s rounds on
    ``cfg.num_games`` lanes; :meth:`start` sets the starting positions,
    each :meth:`round` plays one round of the net it is given, in place."""

    def __init__(self, game, cfg: DuelConfig, device,
                 injected: bool = False):
        super().__init__(game, cfg, device, injected)
        G, dev = cfg.num_games, self.device
        self.done = torch.zeros((G,), dtype=torch.bool, device=dev)
        self.result = torch.zeros((G,), dtype=torch.int8, device=dev)

    def start(self) -> None:
        graphs.assign(self.positions, self.initial)
        for x in (self.t, self.done, self.result):
            x.zero_()

    def round(self, net) -> None:
        game, cfg, positions = self.game, self.cfg, self.positions
        reset_tree(self.tree, positions)
        _, pol = run_mcts(
            game, net, self.tree, rollouts=cfg.rollouts, cpuct=cfg.cpuct,
            training=False, generator=self.generator, probs=self.probs)
        u = (torch.rand((cfg.num_games,), generator=self.generator,
                        device=self.device)
             if self.move is None else self.move)
        sampled = cdf_sample(pol, u * row_sum(pol))
        greedy = torch.argmax(pol, dim=0).to(torch.int32)
        action = torch.where(self.t < cfg.temp_moves, sampled, greedy)
        alive = ~self.done
        graphs.assign(positions, where_games(
            alive, game.play(positions, action), positions))
        f, r = game.is_over(positions)
        self.result.copy_(torch.where(alive & f, r, self.result))
        self.done |= f
        self.t += 1


def duel_half(game, net_first: Callable, net_second: Callable,
              generator: torch.Generator | None, cfg: DuelConfig,
              device=None, uniforms: SelfplayUniforms | None = None,
              captured: bool | None = None):
    """All ``cfg.num_games`` games with ``net_first`` moving first, on
    ``device``.  ``captured`` (default: on a CUDA device) replays the
    rounds from CUDA graphs, one per net, which the two halves of a duel
    share (:mod:`alphatpu_torch.graphs`); ``captured=False`` runs them
    eagerly.  Returns ``(wins_first, draws, wins_second, unfinished)`` as
    0-d tensors."""
    T = cfg.max_moves or game.max_game_length
    nets = (net_first, net_second)
    dev = torch.empty(0, device=device).device
    captured = graphs.use_graphs(captured, dev)

    def make():
        return DuelRounds(game, cfg, dev, uniforms is not None)

    key = DuelRounds.key("duel", game, cfg, uniforms, dev)
    st = graphs.rounds_for(key, nets, make) if captured else make()
    st.start()
    graphs.play(st, T, lambda t: nets[t % 2], generator,
                st.feeder(uniforms), captured)
    result, done = st.result, st.done
    return (((result == 1) & done).sum(), ((result == 0) & done).sum(),
            ((result == -1) & done).sum(), (~done).sum())


def duel_network(game, net_a: Callable, net_b: Callable,
                 generator: torch.Generator | None, cfg: DuelConfig,
                 device=None):
    """Half the games with each net starting.  Returns host ints
    ``(wins_a, draws, wins_b, unfinished)``."""
    half = cfg._replace(num_games=cfg.num_games // 2)
    wa1, d1, wb1, u1 = duel_half(game, net_a, net_b, generator, half, device)
    wb2, d2, wa2, u2 = duel_half(game, net_b, net_a, generator, half, device)
    return (int(wa1 + wa2), int(d1 + d2), int(wb1 + wb2), int(u1 + u2))


def elo_update(wins: int, draws: int, losses: int, current_elo: float):
    """Incremental Elo of the candidate against the incumbent:
    ``EA = games / (w + d/2)``, ``new = -400 log10(EA - 1) + current``,
    and +-400 where the score is all or nothing."""
    games = wins + draws + losses
    score = wins + 0.5 * draws
    if score <= 0:
        return current_elo - 400.0
    ea = games / score
    if ea <= 1.0:
        return current_elo + 400.0
    return -400.0 * math.log10(ea - 1.0) + current_elo
