"""Strength evaluation utilities.

Counterpart of :mod:`alphatpu.eval`:

* :func:`eval_vs_random` - batched games of the candidate (full MCTS,
  greedy) against a uniform-random legal mover; the cheapest
  absolute-strength floor.  A game still running at the move bound counts
  as a draw.  Each half's plies run on static state
  (:class:`EvalRounds`), replayed on the card from a CUDA graph, as the
  reference jits the half's ``scan``.
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

from . import graphs, resolve_device
from .duel import DuelConfig, duel_network
from .games.base import where_games
from .mcts.newton import cdf_sample
from .mcts.search import run_mcts
from .mcts.tree import reset_tree
from .selfplay import SearchRounds, SelfplayUniforms, broadcast_initial


class EvalConfig(NamedTuple):
    num_games: int = 256
    rollouts: int = 64
    cpuct: float = 1.5
    max_moves: int | None = None


class EvalRounds(SearchRounds):
    """The static state of :func:`_vs_random_half`'s plies on
    ``cfg.num_games`` lanes: the games' outcomes and which side the net
    plays (a device flag, so both halves replay one program); each
    :meth:`round` plays one ply of the net it is given, in place."""

    def __init__(self, game, cfg: EvalConfig, device,
                 injected: bool = False):
        super().__init__(game, cfg, device, injected)
        G, dev = cfg.num_games, self.device
        self.done = torch.zeros((G,), dtype=torch.bool, device=dev)
        self.result = torch.zeros((G,), dtype=torch.int8, device=dev)
        self.net_first = torch.zeros((), dtype=torch.bool, device=dev)

    def start(self, positions0, net_first: bool) -> None:
        graphs.assign(self.positions, positions0)
        self.net_first.fill_(net_first)
        for x in (self.t, self.done, self.result):
            x.zero_()

    def round(self, net) -> None:
        game, cfg, positions = self.game, self.cfg, self.positions
        G = cfg.num_games
        reset_tree(self.tree, positions)
        _, pol = run_mcts(
            game, net, self.tree, rollouts=cfg.rollouts, cpuct=cfg.cpuct,
            training=False, generator=self.generator, probs=self.probs)
        net_action = torch.argmax(pol, dim=0).to(torch.int32)
        legal = game.legal_mask(positions)  # [G, A]
        u = (torch.rand((G,), generator=self.generator, device=self.device)
             if self.move is None else self.move)
        rnd_action = cdf_sample(legal.T.to(torch.float32), u * legal.sum(-1))
        net_turn = (self.t % 2 == 0) == self.net_first
        action = torch.where(net_turn, net_action, rnd_action)
        alive = ~self.done
        graphs.assign(positions, where_games(
            alive, game.play(positions, action), positions))
        f, r = game.is_over(positions)
        self.result.copy_(torch.where(alive & f, r, self.result))
        self.done |= f
        self.t += 1


def _vs_random_half(game, net, generator, positions0, cfg: EvalConfig,
                    net_first: bool, uniforms: SelfplayUniforms | None = None,
                    captured: bool | None = None):
    """All games with the net moving first (or second), on the device of
    ``positions0``, for exactly ``T = cfg.max_moves or max_game_length``
    plies: the net searches every ply and a finished game's moves are
    masked.  The net plays greedily (diversity comes from the random
    mover).  Random numbers per ply: the search's uniforms, then one
    uniform per game for the random mover, from ``generator`` or from
    ``uniforms`` (``probs[t]``, ``move[t]``).  ``captured`` (default: on a
    CUDA device) replays the plies from a CUDA graph
    (:mod:`alphatpu_torch.graphs`); ``captured=False`` runs them eagerly.
    Returns (net_wins, draws, net_losses, unfinished) as 0-d tensors."""
    T = cfg.max_moves or game.max_game_length
    dev = positions0.player.device
    captured = graphs.use_graphs(captured, dev)

    def make():
        return EvalRounds(game, cfg, dev, uniforms is not None)

    key = EvalRounds.key("eval", game, cfg, uniforms, dev)
    st = graphs.rounds_for(key, (net,), make) if captured else make()
    st.start(positions0, net_first)
    graphs.play(st, T, lambda t: net, generator, st.feeder(uniforms),
                captured)
    net_sign = 1 if net_first else -1
    result, done = st.result, st.done
    return (((result == net_sign) & done).sum(),
            ((result == 0) & done).sum(),
            ((result == -net_sign) & done).sum(), (~done).sum())


def eval_vs_random(game, net, generator, cfg: EvalConfig = EvalConfig(),
                   device="cuda", captured: bool | None = None):
    """(wins, draws, losses) for the net over ``num_games`` games vs a
    uniform-random legal mover, half starting each.  The rare game not
    finished at the move bound counts as a draw.  ``captured``: as
    :func:`_vs_random_half` takes it; the call waits for the device once,
    for the three counts."""
    dev = resolve_device(device)
    half = cfg._replace(num_games=cfg.num_games // 2)
    positions0 = broadcast_initial(game, half.num_games, dev)
    w1, d1, l1, u1 = _vs_random_half(game, net, generator, positions0, half,
                                     True, captured=captured)
    w2, d2, l2, u2 = _vs_random_half(game, net, generator, positions0, half,
                                     False, captured=captured)
    w, d, l = torch.stack([w1 + w2, d1 + d2 + u1 + u2, l1 + l2]).tolist()
    return w, d, l


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
