"""Gobang / N-in-a-row on an NxN board (TicTacToe is n=3, nvict=3),
batched over games.

Counterpart of :mod:`alphatpu.games.gobang`: action ``a`` is cell ``a``
(column-major, cell (r, c) -> r + n*c), legal iff the cell is empty; a win
is ``nvict`` stones in a row along any of the four directions, tested with
``nvict - 1`` shift-ANDs per direction; the game is drawn when the board is
full.  ``round`` starts at 0 (connect4's starts at 1).  ``is_over`` runs
the ``line_is_over`` kernel on the card (:mod:`alphatpu_torch.games.kernels`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import bitboard as bb
from . import kernels as R
from .base import Game


class GobangState(NamedTuple):
    bplayer: torch.Tensor  # i64[G, nwords] - side to move
    bopponent: torch.Tensor  # i64[G, nwords]
    player: torch.Tensor  # i8[G], +1 first mover
    round: torch.Tensor  # i32[G]


class Gobang(Game):
    is_over_kernel = "line_is_over"

    def __init__(self, n: int = 3, nvict: int | None = None):
        if n > 13:
            raise ValueError(f"gobang{n}: boards up to 13x13 are supported")
        self.n = n
        self.nvict = nvict if nvict is not None else n
        self.spec = bb.BoardSpec(rows=n, cols=n)
        nn = n * n
        self.name = f"gobang{n}" if self.nvict != 3 or n != 3 else "tictactoe"
        self.max_actions = nn
        self.vectorized_state = nn
        self.feature_size = nn
        self.max_game_length = nn
        # the first mover needs nvict stones -> 2*nvict - 1 plies minimum
        self.min_game_length = 2 * self.nvict - 1

    def initial(self, num_games: int, device=None) -> GobangState:
        return GobangState(
            bplayer=bb.empty(self.spec, (num_games,), device),
            bopponent=bb.empty(self.spec, (num_games,), device),
            player=torch.ones((num_games,), dtype=torch.int8, device=device),
            round=torch.zeros((num_games,), dtype=torch.int32, device=device),
        )

    def legal_mask(self, pos: GobangState) -> torch.Tensor:
        occupied = pos.bplayer | pos.bopponent
        return bb.to_planes(self.spec, occupied, dtype=torch.int32) == 0

    def play(self, pos: GobangState, action) -> GobangState:
        bplayer = bb.set_bit(self.spec, pos.bplayer, action)
        return GobangState(
            bplayer=pos.bopponent,
            bopponent=bplayer,
            player=-pos.player,
            round=pos.round + 1,
        )

    def is_over(self, pos: GobangState):
        return R.line_is_over(self.spec, self.nvict, pos.bplayer,
                              pos.bopponent, pos.player)


def tictactoe() -> Gobang:
    return Gobang(3, 3)
