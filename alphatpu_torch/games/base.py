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

    def encode(self, pos) -> torch.Tensor:
        """f32[G, 2 * vectorized_state]: [bplayer planes; bopponent planes]."""
        raise NotImplementedError

    def final_feature(self, pos) -> torch.Tensor:
        """int8[G, feature_size]: +player where bplayer has a stone, -player
        elsewhere."""
        raise NotImplementedError

    @property
    def encoded_size(self) -> int:
        return 2 * self.vectorized_state
