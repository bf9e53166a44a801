"""Reversi / Othello on 6x6 or 8x8 boards with an explicit pass action,
batched over games.

Counterpart of :mod:`alphatpu.games.reversi`:

* legal moves by 8-direction candidate propagation, and flips per
  direction with an end-cap test, each as a static loop of ``size - 2``
  steps (the longest flip line),
* the state caches the legal-move bitboard of the side to move (``legal``),
* the pass action is index ``size*size``, legal iff no placing move
  exists; playing it leaves the board as it is,
* the game is over when neither side can move, and won by disc count.

``play`` and ``is_over`` run the ``reversi_play`` and ``reversi_is_over``
kernels on the card (:mod:`alphatpu_torch.games.kernels`, where the rules'
plain versions live).

Initial position, for size s and h = s // 2: the side to move holds
(h, h-1) and (h-1, h), the other side (h-1, h-1) and (h, h).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import bitboard as bb
from . import kernels as R
from .base import Game


class ReversiState(NamedTuple):
    bplayer: torch.Tensor  # i64[G, nwords]
    bopponent: torch.Tensor  # i64[G, nwords]
    legal: torch.Tensor  # i64[G, nwords] - placing moves of the side to move
    player: torch.Tensor  # i8[G]


class Reversi(Game):
    play_kernel = "reversi_play"
    is_over_kernel = "reversi_is_over"

    def __init__(self, size: int = 8):
        if size not in (6, 8):
            raise ValueError(f"reversi{size}x{size}: sizes 6 and 8 exist")
        self.size = size
        self.spec = bb.BoardSpec(rows=size, cols=size)
        cells = size * size
        self.name = f"reversi{size}x{size}"
        self.max_actions = cells + 1  # the pass action last
        self.vectorized_state = cells
        self.feature_size = cells
        self.max_game_length = 50 if size == 6 else 70
        # a conservative floor (the shortest known 8x8 wipe-out is 9 plies)
        self.min_game_length = 5
        h = size // 2
        self._start_mover = bb.from_coords(self.spec, [(h, h - 1), (h - 1, h)])
        self._start_other = bb.from_coords(self.spec,
                                           [(h - 1, h - 1), (h, h)])

    def initial(self, num_games: int, device=None) -> ReversiState:
        mover = self._const("_start_mover", device).expand(num_games, -1)
        other = self._const("_start_other", device).expand(num_games, -1)
        return ReversiState(
            bplayer=mover.clone(),
            bopponent=other.clone(),
            legal=R.legal_board_plain(self.spec, mover, other),
            player=torch.ones((num_games,), dtype=torch.int8, device=device),
        )

    def legal_mask(self, pos: ReversiState) -> torch.Tensor:
        planes = bb.to_planes(self.spec, pos.legal, dtype=torch.int32) != 0
        can_pass = (pos.legal == 0).all(-1, keepdim=True)
        return torch.cat([planes, can_pass], dim=-1)

    def play(self, pos: ReversiState, action) -> ReversiState:
        return ReversiState(*R.reversi_play(self.spec, pos.bplayer,
                                            pos.bopponent, pos.player,
                                            action))

    def is_over(self, pos: ReversiState):
        return R.reversi_is_over(self.spec, pos.bplayer, pos.bopponent,
                                 pos.legal, pos.player)
