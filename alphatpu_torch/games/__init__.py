"""Game registry.  Connect-4 is ported; the other families of
:mod:`alphatpu.games` are still to come (ROADMAP.md, queue 1, item 1)."""
from __future__ import annotations

import re

from .base import Game
from .connect4 import Connect4

__all__ = ["Game", "Connect4", "make_game", "GAME_NAMES"]

GAME_NAMES = ("connect4",)

_NOT_PORTED = re.compile(
    r"tictactoe|gobang\d+|hex\d+|reversi(6x6|8x8|6|8)?")


def make_game(name: str) -> Game:
    """Build a game by name.  Only ``connect4`` exists in the port so far."""
    name = name.lower()
    if name == "connect4":
        return Connect4()
    if _NOT_PORTED.fullmatch(name):
        raise NotImplementedError(
            f"game {name!r} is not ported to alphatpu_torch yet: its family "
            "is listed in ROADMAP.md, queue 1 ('Modules to port'), item 1")
    raise ValueError(f"unknown game {name!r}; known: {GAME_NAMES}")
