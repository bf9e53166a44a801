"""Independent numpy game-rule oracles: the host-side rules of the CPU
engine (:mod:`alphatpu_torch.cpu_mcts`) and a cross-check of the tensor
games.

Counterpart of :mod:`alphatpu.oracles`, copied unchanged below this
docstring.  These are written from the rules of each game, not translated
from the tensor code.

State convention mirrors the framework: `mover` is the grid of the side to
move, `other` the opponent; `player` is +1 for the first mover and flips
each ply; results are absolute (+1 = first mover wins).
"""
from __future__ import annotations

import numpy as np


class OracleBase:
    rows: int
    cols: int

    def legal_actions(self, st):
        raise NotImplementedError

    def play(self, st, a):
        raise NotImplementedError

    def is_over(self, st):
        raise NotImplementedError

    def planes(self, st):
        """(mover_plane, other_plane) flattened column-major (cell = r + rows*c)."""
        mover, other = st["mover"], st["other"]
        return (
            mover.T.reshape(-1).astype(np.float32),
            other.T.reshape(-1).astype(np.float32),
        )


def _line_exists(grid, nvict):
    """Any nvict-in-a-row horizontally, vertically, or diagonally."""
    r, c = grid.shape
    for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        for i in range(r):
            for j in range(c):
                cnt = 0
                x, y = i, j
                while 0 <= x < r and 0 <= y < c and grid[x, y]:
                    cnt += 1
                    if cnt >= nvict:
                        return True
                    x += dr
                    y += dc
    return False


class OracleGobang(OracleBase):
    def __init__(self, n, nvict):
        self.rows = self.cols = n
        self.nvict = nvict

    def initial(self):
        z = np.zeros((self.rows, self.cols), dtype=bool)
        return {"mover": z.copy(), "other": z.copy(), "player": 1}

    def legal_actions(self, st):
        empty = ~(st["mover"] | st["other"])
        return [r + self.rows * c for c in range(self.cols)
                for r in range(self.rows) if empty[r, c]]

    def play(self, st, a):
        r, c = a % self.rows, a // self.rows
        mover = st["mover"].copy()
        mover[r, c] = True
        return {"mover": st["other"], "other": mover, "player": -st["player"]}

    def is_over(self, st):
        if _line_exists(st["other"], self.nvict):
            return True, -st["player"]
        if (st["mover"] | st["other"]).all():
            return True, 0
        return False, 0


class OracleConnect4(OracleBase):
    rows, cols, nvict = 6, 7, 4

    def initial(self):
        z = np.zeros((self.rows, self.cols), dtype=bool)
        return {"mover": z.copy(), "other": z.copy(), "player": 1}

    def legal_actions(self, st):
        occ = st["mover"] | st["other"]
        return [c for c in range(self.cols) if not occ[:, c].all()]

    def play(self, st, a):
        occ = st["mover"] | st["other"]
        # gravity toward the highest row index
        r = max(r for r in range(self.rows) if not occ[r, a])
        mover = st["mover"].copy()
        mover[r, a] = True
        return {"mover": st["other"], "other": mover, "player": -st["player"]}

    def is_over(self, st):
        if _line_exists(st["other"], self.nvict):
            return True, -st["player"]
        if (st["mover"] | st["other"]).all():
            return True, 0
        return False, 0


class OracleHex(OracleBase):
    """Standard hex on the inner NxN board; the framework's embedded border
    stones are reproduced for plane comparison but the win test is an
    independent BFS: player +1 connects inner column 0 to column N-1,
    player -1 connects inner row 0 to row N-1, with skew-diagonal adjacency
    (r-1,c+1)/(r+1,c-1)."""

    def __init__(self, n):
        self.n = n
        self.rows = self.cols = n + 1

    def initial(self):
        m = self.n + 1
        mover = np.zeros((m, m), dtype=bool)
        other = np.zeros((m, m), dtype=bool)
        mover[2:m, 0] = True  # first mover's border: col 0, rows 2..n
        other[0, 2:m] = True  # second mover's border: row 0, cols 2..n
        return {"mover": mover, "other": other, "player": 1}

    def _embed(self, a):
        x, y = a // self.n, a % self.n
        return y + 1, x + 1  # (row, col) in the embedded board

    def legal_actions(self, st):
        occ = st["mover"] | st["other"]
        out = []
        for a in range(self.n * self.n):
            r, c = self._embed(a)
            if not occ[r, c]:
                out.append(a)
        return out

    def play(self, st, a):
        r, c = self._embed(a)
        mover = st["mover"].copy()
        mover[r, c] = True
        return {"mover": st["other"], "other": mover, "player": -st["player"]}

    def _connected(self, inner, cross_cols):
        """BFS over True cells of inner [n,n] grid (indexed [row-1, col-1] of
        the embedding); cross_cols: connect col 0 to col n-1, else rows."""
        n = self.n
        if cross_cols:
            frontier = [(r, 0) for r in range(n) if inner[r, 0]]
            target = lambda r, c: c == n - 1
        else:
            frontier = [(0, c) for c in range(n) if inner[0, c]]
            target = lambda r, c: r == n - 1
        seen = set(frontier)
        while frontier:
            r, c = frontier.pop()
            if target(r, c):
                return True
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1), (-1, 1), (1, -1)):
                x, y = r + dr, c + dc
                if 0 <= x < n and 0 <= y < n and inner[x, y] and (x, y) not in seen:
                    seen.add((x, y))
                    frontier.append((x, y))
        return False

    def is_over(self, st):
        # the just-moved side is `other`; previous mover id = -player
        prev = -st["player"]
        inner = st["other"][1:, 1:]
        win = self._connected(inner, cross_cols=(prev == 1))
        return (True, prev) if win else (False, 0)


class OracleReversi(OracleBase):
    DIRS = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)]

    def __init__(self, size):
        self.size = self.rows = self.cols = size

    def initial(self):
        s = self.size
        h = s // 2
        mover = np.zeros((s, s), dtype=bool)
        other = np.zeros((s, s), dtype=bool)
        mover[h, h - 1] = mover[h - 1, h] = True
        other[h - 1, h - 1] = other[h, h] = True
        return {"mover": mover, "other": other, "player": 1}

    def _moves(self, me, adv):
        s = self.size
        occ = me | adv
        out = set()
        for r in range(s):
            for c in range(s):
                if not me[r, c]:
                    continue
                for dr, dc in self.DIRS:
                    x, y = r + dr, c + dc
                    run = 0
                    while 0 <= x < s and 0 <= y < s and adv[x, y]:
                        x += dr
                        y += dc
                        run += 1
                    if run > 0 and 0 <= x < s and 0 <= y < s and not occ[x, y]:
                        out.add(x + s * y)
        return out

    def legal_actions(self, st):
        moves = self._moves(st["mover"], st["other"])
        if moves:
            return sorted(moves)
        return [self.size * self.size]  # pass

    def play(self, st, a):
        s = self.size
        me, adv = st["mover"].copy(), st["other"].copy()
        if a == s * s:  # pass
            return {"mover": adv, "other": me, "player": -st["player"]}
        r, c = a % s, a // s
        assert not me[r, c] and not adv[r, c]
        flips = []
        for dr, dc in self.DIRS:
            x, y = r + dr, c + dc
            line = []
            while 0 <= x < s and 0 <= y < s and adv[x, y]:
                line.append((x, y))
                x += dr
                y += dc
            if line and 0 <= x < s and 0 <= y < s and me[x, y]:
                flips.extend(line)
        me[r, c] = True
        for x, y in flips:
            me[x, y] = True
            adv[x, y] = False
        return {"mover": adv, "other": me, "player": -st["player"]}

    def is_over(self, st):
        if self._moves(st["mover"], st["other"]) or self._moves(
            st["other"], st["mover"]
        ):
            return False, 0
        diff = int(st["mover"].sum()) - int(st["other"].sum())
        return True, int(np.sign(diff)) * st["player"]
