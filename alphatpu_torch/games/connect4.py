"""Connect-4 (6x7, gravity drop, 4-in-a-row), batched over games.

Counterpart of :mod:`alphatpu.games.connect4`: stones stack from row 5
(bottom) toward row 0, the landing row is ``rows - 1 - count(stones in
column)``, a column is legal iff its row 0 is free, and a win is four in a
row along any of the four directions (the ``line_is_over`` kernel on the
card, :mod:`alphatpu_torch.games.kernels`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import bitboard as bb
from . import kernels as R
from .base import Game

HEIGHT = 6
WIDTH = 7
NVICT = 4


class Connect4State(NamedTuple):
    bplayer: torch.Tensor  # i64[G, nwords], one 32-bit word per element
    bopponent: torch.Tensor  # i64[G, nwords]
    player: torch.Tensor  # i8[G]
    round: torch.Tensor  # i32[G]


class Connect4(Game):
    is_over_kernel = "line_is_over"
    nvict = NVICT

    def __init__(self):
        self.spec = bb.BoardSpec(rows=HEIGHT, cols=WIDTH)
        self.name = "connect4"
        self.max_actions = WIDTH
        self.vectorized_state = HEIGHT * WIDTH
        self.feature_size = HEIGHT * WIDTH
        self.max_game_length = HEIGHT * WIDTH
        # Four first-mover discs + three replies -> 7 plies minimum.
        self.min_game_length = 7
        self._col_masks = np.stack([
            self.spec.mask_from_bits(lambda i, c=c: i // HEIGHT == c)
            for c in range(WIDTH)])  # [WIDTH, nwords]
        self._top_cells = np.arange(WIDTH) * HEIGHT  # row 0 of each column

    def initial(self, num_games: int, device=None) -> Connect4State:
        return Connect4State(
            bplayer=bb.empty(self.spec, (num_games,), device),
            bopponent=bb.empty(self.spec, (num_games,), device),
            player=torch.ones((num_games,), dtype=torch.int8, device=device),
            round=torch.ones((num_games,), dtype=torch.int32, device=device),
        )

    def legal_mask(self, pos: Connect4State) -> torch.Tensor:
        occupied = pos.bplayer | pos.bopponent
        planes = bb.to_planes(self.spec, occupied, dtype=torch.int32)
        return planes[:, self._const("_top_cells", occupied.device)] == 0

    def play(self, pos: Connect4State, action) -> Connect4State:
        occupied = pos.bplayer | pos.bopponent
        action = torch.as_tensor(action, device=occupied.device).long()
        col_mask = self._const("_col_masks", occupied.device)[action]
        count = bb.popcount(self.spec, occupied & col_mask)
        cell = action * HEIGHT + (HEIGHT - 1 - count)
        bplayer = bb.set_bit(self.spec, pos.bplayer, cell)
        return Connect4State(
            bplayer=pos.bopponent,
            bopponent=bplayer,
            player=-pos.player,
            round=pos.round + 1,
        )

    def is_over(self, pos: Connect4State):
        return R.line_is_over(self.spec, self.nvict, pos.bplayer,
                              pos.bopponent, pos.player)
