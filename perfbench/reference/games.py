"""Plain rules of the benchmark's games on dense boards, in NumPy.

A position is ``(me, opp, player)``: ``me`` and ``opp`` are bool[N, rows,
cols] boards of the side to move and of the other side, ``player`` is
int8[N], +1 for the side that moved first.  Actions and the net's input
planes number the cells column-major, cell ``(r, c)`` is ``r + rows * c``.

* Reversi (6x6, 8x8): a disc flips every straight line of the other side's
  discs that it closes against one of the mover's own; a move is legal
  where it flips something; the pass is the last action and is legal only
  where no disc can be placed; the game ends when neither side can place
  one and is won by the disc count.
* Gobang (N x N, ``nvict`` in a row): a stone on any empty cell; the
  previous mover wins with ``nvict`` or more in a row along a row, a
  column or a diagonal; a full board is a draw.

``result`` is from the first mover's view: +1, 0 or -1.
"""
from __future__ import annotations

import re

import numpy as np

DIRECTIONS = ((-1, 0), (1, 0), (0, -1), (0, 1),
              (-1, -1), (1, -1), (-1, 1), (1, 1))
LINES = ((0, 1), (1, 0), (1, 1), (1, -1))


def shift(board: np.ndarray, dr: int, dc: int) -> np.ndarray:
    """``out[r, c] = board[r - dr, c - dc]``, empty where that is off the
    board."""
    out = np.zeros_like(board)
    rows, cols = board.shape[-2:]
    out[..., max(dr, 0):rows + min(dr, 0), max(dc, 0):cols + min(dc, 0)] = \
        board[..., max(-dr, 0):rows - max(dr, 0), max(-dc, 0):cols - max(dc, 0)]
    return out


def cells(board: np.ndarray) -> np.ndarray:
    """bool[N, rows, cols] -> bool[N, rows * cols], column-major."""
    return np.swapaxes(board, -1, -2).reshape(board.shape[:-2] + (-1,))


def board_of(flat: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """The inverse of :func:`cells`."""
    return np.swapaxes(flat.reshape(flat.shape[:-1] + (cols, rows)), -1, -2)


class Game:
    rows: int
    cols: int
    actions: int
    max_length: int

    @property
    def cells(self) -> int:
        return self.rows * self.cols

    def encode(self, me, opp) -> np.ndarray:
        """float32[N, 2 * cells]: the mover's cells, then the other's."""
        return np.concatenate([cells(me), cells(opp)], -1).astype(np.float32)

    def decode(self, enc) -> tuple:
        """``(me, opp)`` from an encoding (any dtype, 0/1)."""
        c = self.cells
        e = np.asarray(enc) != 0
        return (board_of(e[..., :c], self.rows, self.cols),
                board_of(e[..., c:], self.rows, self.cols))

    def final_feature(self, me, player) -> np.ndarray:
        """int8[N, cells]: +player on the mover's stones, -player
        elsewhere."""
        p = player.astype(np.int8)[:, None]
        return np.where(cells(me), p, -p).astype(np.int8)


class Reversi(Game):
    def __init__(self, size: int):
        self.rows = self.cols = size
        self.actions = size * size + 1
        self.max_length = 50 if size == 6 else 70

    def initial(self, n: int) -> tuple:
        s, h = self.rows, self.rows // 2
        me = np.zeros((n, s, s), bool)
        opp = np.zeros((n, s, s), bool)
        me[:, h, h - 1] = me[:, h - 1, h] = True
        opp[:, h - 1, h - 1] = opp[:, h, h] = True
        return me, opp, np.ones(n, np.int8)

    def placeable(self, me, opp) -> np.ndarray:
        """bool[N, rows, cols]: the empty cells where ``me`` flips a
        line."""
        empty = ~(me | opp)
        out = np.zeros_like(me)
        for dr, dc in DIRECTIONS:
            run = shift(me, dr, dc) & opp
            while run.any():
                nxt = shift(run, dr, dc)
                out |= nxt & empty
                run = nxt & opp
        return out

    def legal(self, me, opp) -> np.ndarray:
        place = cells(self.placeable(me, opp))
        return np.concatenate([place, ~place.any(-1, keepdims=True)], -1)

    def flips(self, me, opp, placed) -> np.ndarray:
        """The discs of ``opp`` that a disc on ``placed`` flips."""
        out = np.zeros_like(me)
        for dr, dc in DIRECTIONS:
            line = np.zeros_like(me)
            run = shift(placed, dr, dc) & opp
            while run.any():
                line |= run
                run = shift(run, dr, dc) & opp
            closed = (shift(line, dr, dc) & me).any((-1, -2))
            out |= line & closed[:, None, None]
        return out

    def play(self, me, opp, player, action) -> tuple:
        """The position after each game's ``action`` (the pass included)."""
        action = np.asarray(action)
        n = me.shape[0]
        flat = np.zeros((n, self.cells), bool)
        placing = action < self.cells
        flat[np.nonzero(placing)[0], action[placing]] = True
        placed = board_of(flat, self.rows, self.cols)
        f = self.flips(me, opp, placed)
        return opp & ~f, me | f | placed, -player

    def is_over(self, me, opp, player) -> tuple:
        done = ~(self.placeable(me, opp).any((-1, -2))
                 | self.placeable(opp, me).any((-1, -2)))
        diff = (me.sum((-1, -2)).astype(np.int64)
                - opp.sum((-1, -2)).astype(np.int64))
        result = np.sign(diff).astype(np.int8) * player
        return done, np.where(done, result, 0).astype(np.int8)


class Gobang(Game):
    def __init__(self, n: int, nvict: int):
        self.rows = self.cols = n
        self.nvict = nvict
        self.actions = n * n
        self.max_length = n * n

    def initial(self, n: int) -> tuple:
        z = np.zeros((n, self.rows, self.cols), bool)
        return z, z.copy(), np.ones(n, np.int8)

    def legal(self, me, opp) -> np.ndarray:
        return ~cells(me | opp)

    def wins(self, board) -> np.ndarray:
        """bool[N]: ``nvict`` or more stones in a row on ``board``."""
        out = np.zeros(board.shape[0], bool)
        for dr, dc in LINES:
            run = board.copy()
            for k in range(1, self.nvict):
                run &= shift(board, k * dr, k * dc)
            out |= run.any((-1, -2))
        return out

    def play(self, me, opp, player, action) -> tuple:
        flat = cells(me).copy()
        flat[np.arange(me.shape[0]), np.asarray(action)] = True
        return opp, board_of(flat, self.rows, self.cols), -player

    def is_over(self, me, opp, player) -> tuple:
        win = self.wins(opp)  # the previous mover
        full = (me | opp).all((-1, -2))
        done = win | full
        return done, np.where(win, -player, 0).astype(np.int8)


def make(name: str) -> Game:
    """``reversi6x6``, ``reversi8x8`` or ``gobang<N>`` (five in a row from
    N = 8 up, N in a row below)."""
    m = re.fullmatch(r"reversi(\d+)x\1", name)
    if m:
        return Reversi(int(m.group(1)))
    m = re.fullmatch(r"gobang(\d+)", name)
    if m:
        n = int(m.group(1))
        return Gobang(n, 5 if n >= 8 else n)
    raise ValueError(f"no plain rules for {name!r}")
