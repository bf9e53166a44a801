"""Game registry: the five game families of :mod:`alphatpu.games`
(Gobang/TicTacToe for any N <= 13, Connect-4, Reversi 6x6 and 8x8, Hex for
any N <= 13)."""
from __future__ import annotations

import re

from .base import Game
from .connect4 import Connect4
from .gobang import Gobang, tictactoe
from .hex import Hex
from .reversi import Reversi

__all__ = ["Game", "Gobang", "Connect4", "Hex", "Reversi", "tictactoe",
           "make_game", "GAME_NAMES"]

GAME_NAMES = ("tictactoe", "gobang<N>", "connect4", "hex<N>", "reversi6x6",
              "reversi8x8")


def make_game(name: str, nvict: int | None = None) -> Game:
    """Build a game by name: ``tictactoe``, ``connect4``, ``gobang<N>``
    (``nvict`` stones in a row; default 5 for N >= 8, else N), ``hex<N>``,
    ``reversi6x6`` / ``reversi6``, ``reversi8x8`` / ``reversi8`` /
    ``reversi``.  ``nvict`` is for gobang only."""
    name = name.lower()
    m = re.fullmatch(r"gobang(\d+)", name)
    if m:
        n = int(m.group(1))
        return Gobang(n, nvict if nvict is not None else (5 if n >= 8 else n))
    if nvict is not None:
        raise ValueError(f"nvict is a gobang<N> option, not one of {name!r}")
    if name == "tictactoe":
        return tictactoe()
    if name == "connect4":
        return Connect4()
    if name in ("reversi6x6", "reversi6"):
        return Reversi(6)
    if name in ("reversi8x8", "reversi8", "reversi"):
        return Reversi(8)
    m = re.fullmatch(r"hex(\d+)", name)
    if m:
        return Hex(int(m.group(1)))
    raise ValueError(f"unknown game {name!r}; known: {', '.join(GAME_NAMES)}")
