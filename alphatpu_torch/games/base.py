"""Uniform game contract, batched over a leading games axis.

Counterpart of :mod:`alphatpu.games.base`.  The reference writes each rule
for one unbatched state and ``vmap``s it; here every method takes a state
whose leaves lead with the games axis ``G`` and returns batched tensors.
The conventions are the reference's:

* ``bplayer`` holds the stones of the side to move, ``bopponent`` the other
  side; ``play`` swaps them and negates ``player``,
* ``player`` is +1 for the first mover and alternates each ply,
* ``is_over`` returns ``(done, result)`` with ``result`` in {-1, 0, +1}
  from the absolute (player=+1) perspective,
* actions are 0-based.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import bitboard as bb


def where_games(mask: torch.Tensor, a, b):
    """Per game: the leaves of state ``a`` where ``mask`` [G], else those
    of ``b``."""
    return type(a)(*(
        torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)))


class Game:
    """Abstract interface; concrete games define the attributes below.

    Attributes
    ----------
    name: str
    max_actions: int
    vectorized_state: int      # cells in the net's input planes
    feature_size: int
    max_game_length: int
    min_game_length: int       # safe lower bound on plies to termination
    """

    name: str
    max_actions: int
    vectorized_state: int
    feature_size: int
    max_game_length: int
    min_game_length: int = 1
    # the rules kernels (games/kernels.py) that play and is_over launch on
    # the card, by wrapper name; None where the rule runs as torch ops
    play_kernel: str | None = None
    is_over_kernel: str | None = None

    def initial(self, num_games: int, device=None) -> NamedTuple:
        """``num_games`` copies of the starting position."""
        raise NotImplementedError

    def legal_mask(self, pos) -> torch.Tensor:
        """bool[G, max_actions]."""
        raise NotImplementedError

    def play(self, pos, action: torch.Tensor) -> NamedTuple:
        """The positions after each game's ``action`` (i32/i64[G])."""
        raise NotImplementedError

    def is_over(self, pos) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bool[G] done, int8[G] result)."""
        raise NotImplementedError

    @property
    def encoded_size(self) -> int:
        return 2 * self.vectorized_state

    def _const(self, name: str, device) -> torch.Tensor:
        """The numpy attribute ``name`` as a tensor on ``device``, built
        once per device."""
        consts = self.__dict__.setdefault("_consts", {})
        key = (name, device)
        if key not in consts:
            consts[key] = torch.as_tensor(getattr(self, name), device=device)
        return consts[key]

    def encode(self, pos) -> torch.Tensor:
        """f32[G, 2 * vectorized_state]: [bplayer planes; bopponent planes]."""
        return torch.cat([bb.to_planes(self.spec, pos.bplayer),
                          bb.to_planes(self.spec, pos.bopponent)], dim=-1)

    def final_feature(self, pos) -> torch.Tensor:
        """int8[G, feature_size]: +player where bplayer has a stone, -player
        elsewhere."""
        p = bb.to_planes(self.spec, pos.bplayer, dtype=torch.int8)
        player = pos.player.to(torch.int8).unsqueeze(-1)
        return torch.where(p != 0, player, -player)

    def _board_rows(self, pos) -> list:
        """The text rows of a one-game position (leaves leading with G = 1),
        copied to the host: X for the first mover's stones, O for the
        second's, ``.`` for empty; cell (r, c) is bit r + rows * c."""
        rows, cols = self.spec.rows, self.spec.cols
        bp = bb.to_planes(self.spec, pos.bplayer[0]).tolist()
        bo = bb.to_planes(self.spec, pos.bopponent[0]).tolist()
        sp, so = ("X", "O") if int(pos.player[0]) == 1 else ("O", "X")
        return [" ".join(sp if bp[r + rows * c] else so if bo[r + rows * c]
                         else "." for c in range(cols))
                for r in range(rows)]

    def render(self, pos) -> str:
        """Host-side text board of a one-game position."""
        return "\n".join(self._board_rows(pos))
