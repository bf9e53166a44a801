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

Initial position, for size s and h = s // 2: the side to move holds
(h, h-1) and (h-1, h), the other side (h-1, h-1) and (h, h).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import bitboard as bb
from .base import Game


class ReversiState(NamedTuple):
    bplayer: torch.Tensor  # i64[G, nwords]
    bopponent: torch.Tensor  # i64[G, nwords]
    legal: torch.Tensor  # i64[G, nwords] - placing moves of the side to move
    player: torch.Tensor  # i8[G]


class Reversi(Game):
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

    def _dirs(self):
        """The eight directions: up, down, left, right, up-left, down-left,
        up-right, down-right."""
        spec = self.spec
        return (
            lambda x: bb.up(spec, x),
            lambda x: bb.down(spec, x),
            lambda x: bb.left(spec, x),
            lambda x: bb.right(spec, x),
            lambda x: bb.up(spec, bb.left(spec, x)),
            lambda x: bb.down(spec, bb.left(spec, x)),
            lambda x: bb.up(spec, bb.right(spec, x)),
            lambda x: bb.down(spec, bb.right(spec, x)),
        )

    def legal_board(self, me: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
        """Bitboard of the placing moves of ``me``."""
        emptyc = bb.invert(self.spec, me | adv)
        out = torch.zeros_like(me)
        for d in self._dirs():
            cand = d(me) & adv
            for _ in range(self.size - 2):
                dc = d(cand)
                out = out | (emptyc & dc)
                cand = adv & dc
            out = out | (emptyc & d(cand))
        return out

    def flip_board(self, me, adv, played) -> torch.Tensor:
        """The discs of ``adv`` that a disc on ``played`` (a board) flips."""
        out = torch.zeros_like(me)
        for d in self._dirs():
            cand = d(played) & adv
            toflip = cand
            for _ in range(self.size - 2):
                cand = adv & d(cand)
                toflip = toflip | cand
            capped = (d(toflip) & me).any(-1, keepdim=True)
            out = out | torch.where(capped, toflip, 0)
        return out

    def initial(self, num_games: int, device=None) -> ReversiState:
        mover = self._const("_start_mover", device).expand(num_games, -1)
        other = self._const("_start_other", device).expand(num_games, -1)
        return ReversiState(
            bplayer=mover.clone(),
            bopponent=other.clone(),
            legal=self.legal_board(mover, other),
            player=torch.ones((num_games,), dtype=torch.int8, device=device),
        )

    def legal_mask(self, pos: ReversiState) -> torch.Tensor:
        planes = bb.to_planes(self.spec, pos.legal, dtype=torch.int32) != 0
        can_pass = (pos.legal == 0).all(-1, keepdim=True)
        return torch.cat([planes, can_pass], dim=-1)

    def play(self, pos: ReversiState, action) -> ReversiState:
        dev = pos.bplayer.device
        action = torch.as_tensor(action, device=dev).long()
        is_pass = (action >= self.size * self.size)[:, None]
        placed = bb.cell_onehot(self.spec, torch.where(is_pass[:, 0], 0,
                                                       action))
        h = self.flip_board(pos.bplayer, pos.bopponent, placed)
        h = torch.where(is_pass, 0, h)
        placed = torch.where(is_pass, 0, placed)
        me = (pos.bplayer ^ h) | placed
        adv = pos.bopponent ^ h
        return ReversiState(
            bplayer=adv,
            bopponent=me,
            legal=self.legal_board(adv, me),
            player=-pos.player,
        )

    def is_over(self, pos: ReversiState):
        spec = self.spec
        opp_moves = self.legal_board(pos.bopponent, pos.bplayer)
        done = (pos.legal == 0).all(-1) & (opp_moves == 0).all(-1)
        diff = bb.popcount(spec, pos.bplayer) - bb.popcount(spec, pos.bopponent)
        result = torch.sign(diff).to(torch.int8) * pos.player
        return done, torch.where(done, result, 0).to(torch.int8)
