"""Hex on an NxN board, embedded in an (N+1)x(N+1) bitboard with
pre-filled border stones, batched over games.

Counterpart of :mod:`alphatpu.games.hex`:

* the first mover's border fills column 0, rows 2..N; the second mover's
  fills row 0, columns 2..N,
* action ``a`` with x = a // n, y = a % n lands on the embedded cell
  (row y+1, column x+1), bit ``(y+1) + m(x+1)`` with m = n+1,
* ``is_over`` is the bit-parallel connectivity flood: 2N-2 steps of
  ``a = down((a & (b|c)) | (b & c))`` with ``b = up(a)``, ``c = right(b)``,
  re-seeding part of row 0 at each step when the side that just moved owns
  that border; the game is won iff the bottom-right corner is reached
  (the ``hex_is_over`` kernel on the card,
  :mod:`alphatpu_torch.games.kernels`),
* the state carries the reference's ``lp`` counter (cells left).

Hex13 needs 196 bits, seven words.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import bitboard as bb
from . import kernels as R
from .base import Game


class HexState(NamedTuple):
    bplayer: torch.Tensor  # i64[G, nwords], border stones included
    bopponent: torch.Tensor  # i64[G, nwords]
    player: torch.Tensor  # i8[G]
    lp: torch.Tensor  # i32[G] - cells left


class Hex(Game):
    is_over_kernel = "hex_is_over"

    def __init__(self, n: int = 7):
        self.n = n
        m = n + 1
        if m * m > 224:
            raise ValueError(f"hex{n}: the board does not fit seven words")
        self.spec = bb.BoardSpec(rows=m, cols=m)
        nn = n * n
        self.name = f"hex{n}"
        self.max_actions = nn
        self.vectorized_state = m * m  # the planes include the border
        self.feature_size = m * m
        self.max_game_length = nn
        # a winning chain needs n stones -> 2n - 1 plies minimum
        self.min_game_length = 2 * n - 1

        self._startx = bb.from_coords(self.spec, [(r, 0) for r in range(2, m)])
        self._starto = bb.from_coords(self.spec, [(0, c) for c in range(2, m)])
        acts = np.arange(nn)
        x, y = acts // n, acts % n
        self._action_cells = (y + 1) + m * (x + 1)

    def initial(self, num_games: int, device=None) -> HexState:
        def board(name):
            return self._const(name, device).expand(num_games, -1).clone()

        return HexState(
            bplayer=board("_startx"),
            bopponent=board("_starto"),
            player=torch.ones((num_games,), dtype=torch.int8, device=device),
            lp=torch.full((num_games,), self.n * self.n, dtype=torch.int32,
                          device=device),
        )

    def legal_mask(self, pos: HexState) -> torch.Tensor:
        occupied = pos.bplayer | pos.bopponent
        planes = bb.to_planes(self.spec, occupied, dtype=torch.int32)
        return planes[:, self._const("_action_cells", occupied.device)] == 0

    def play(self, pos: HexState, action) -> HexState:
        dev = pos.bplayer.device
        action = torch.as_tensor(action, device=dev).long()
        cell = self._const("_action_cells", dev)[action]
        bplayer = bb.set_bit(self.spec, pos.bplayer, cell)
        return HexState(
            bplayer=pos.bopponent,
            bopponent=bplayer,
            player=-pos.player,
            lp=pos.lp - 1,
        )

    def render(self, pos) -> str:
        """The embedded board, border included, each row shifted one
        space right of the one above (the rhombus)."""
        return "\n".join(" " * r + row
                         for r, row in enumerate(self._board_rows(pos)))

    def is_over(self, pos: HexState):
        # the flood runs from the stones (border included) of the side
        # that just moved
        return R.hex_is_over(self.spec, self.n, pos.bopponent, pos.player)
