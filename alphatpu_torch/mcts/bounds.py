"""The least time one H100 could take for one call of each search kernel.

``chip_smoke.py`` reports it beside each kernel's measured time.  A call's
bound is the larger of two times: the bytes it must move - each input
byte it needs read once, each output byte written once - over the card's
memory rate, and the operations it must do over the f32 rate.  Both are
counted from the call's own inputs: their shapes, and the paths and
pending edges they hold.  How deep each game's walk went is read off the
walk's result (a :class:`~alphatpu_torch.mcts.kernels.Selection`, the same
from the kernel and from its plain version).

What a walk must move, per game: the parent and action_from columns (V x
8 B) if it looks up a child; one ``expanded`` flag per node it reaches;
the stats row (A elements of each stat plane: 4 B words, or 2 B for bf16
planes) of each node whose policy it needs - the nodes it records, or the
root when it records none; one
uniform per recorded depth; and its outputs (the [D, G] path, leaf, leaf
action, needs_alloc, the [A, G] root policy).  The apply phase of a
select_apply kernel reads the pending flags and leaves, the [D, G] pending
path, the length and value of each game with a pending edge, and for each
pending edge its action and its stat elements (read and written); each
writing lane reads its new f32 prior row and writes one element per
action.  An element the apply phase writes and the walk then reads counts
twice: a few per game.

Operations are a lower bound: 9 f32 operations per action of each row a
walk reads (one Newton evaluation - subtract, divide, two multiplies, two
adds - the policy's multiply and divide, the prefix add) and 3 per backed
up edge.  The Newton solve takes several evaluations on most nodes; the
operations stay far below the bytes' time all the same.

The game rules' kernels (:func:`rules_cost`) read their boards (32-bit
words in 8 B elements), the action and the player once and write their
outputs once; their operations are counted as one per word for each
shift-step of each direction (the flips' and the legal board's for
``reversi_play``; about ten a word for each of ``hex_is_over``'s 2N-2
flood steps), at the f32 rate - a lower bound of bit operations,
which the bytes' time exceeds at every size but hex13's (24 steps over
seven words against 59 bytes a game).

Peaks: NVIDIA's H100 SXM data sheet, at a 700 W power limit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12  # HBM3
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

# kernel -> (stat elements of one edge in a row read, elements read and
# written per pending edge, elements of one prior-row entry written), each
# element of the planes' itemsize: 4 B for the packed kernels, 4 or 2 B
# (f32 or bf16) for the three-plane kernels
_STORAGE = {
    "select_apply_packed": (2, 2, 1),  # f32 prior + the packed word
    "select_apply_packed1": (1, 2, 1),  # the 1-plane word
    "select_apply": (3, 4, 1),  # three stat planes
    "select": (3, 0, 0),
}
OPS_PER_ACTION = 9
OPS_PER_EDGE = 3
HEX_OPS_PER_WORD = 10


class Cost(NamedTuple):
    """Bytes and operations of one call, and the bound they set."""

    nbytes: int
    ops: int

    @property
    def bytes_ms(self) -> float:
        return self.nbytes / HBM_BYTES_PER_S * 1e3

    @property
    def ops_ms(self) -> float:
        return self.ops / F32_OPS_PER_S * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def walk_cost(kernel: str, V: int, sel, pend=None, itemsize: int = 4) -> Cost:
    """One call of the walk kernel ``kernel`` (a name of ``_STORAGE``) on a
    tree of V nodes that returned ``sel``, with the pending update
    ``pend`` (select_apply kernels) applied first, on stat planes of
    ``itemsize`` bytes an element (2 for bf16)."""
    row_bytes, edge_bytes, word_bytes = (n * itemsize
                                         for n in _STORAGE[kernel])
    A, G = sel.root_pi.shape
    D = sel.nodes.shape[0]
    recorded = (sel.nodes >= 0).sum(0)
    # a walk that stopped at an unexpanded node read that node's flag too
    flags = recorded + (~sel.needs_alloc & (recorded < D)).long()
    rows = int(torch.clamp_min(recorded, 1).sum())
    nbytes = (int((recorded > 0).sum()) * V * 8 + int(flags.sum())
              + rows * A * row_bytes + int(recorded.sum()) * 4
              + D * G * 8 + G * 9 + A * G * 4)
    ops = rows * A * OPS_PER_ACTION
    if pend is not None:
        if not edge_bytes:
            raise ValueError(f"{kernel} has no apply phase")
        valid = pend.nodes >= 0
        edges = int(valid.sum())
        writes = int((pend.write & (pend.leaf >= 0) & (pend.leaf < V)).sum())
        nbytes += (G * 5 + writes * A * (4 + word_bytes) + D * G * 4
                   + int(valid.any(0).sum()) * 8 + edges * (4 + edge_bytes))
        ops += edges * OPS_PER_EDGE
    return Cost(nbytes, ops)


def backup_cost(nodes, itemsize: int = 4) -> Cost:
    """One backup call on the path ``nodes`` [D, G]: the whole path read,
    each game with an edge reads its length and value, each edge its
    action and two read-modify-writes of ``itemsize`` bytes (4 for f32
    planes, 2 for bf16)."""
    D, G = nodes.shape
    valid = nodes >= 0
    edges = int(valid.sum())
    return Cost(D * G * 4 + int(valid.any(0).sum()) * 8
                + edges * (4 + 4 * itemsize), edges * OPS_PER_EDGE)


def rules_cost(kernel: str, spec, G: int, action_bytes: int = 8,
               nvict: int = 0) -> Cost:
    """One call of a rules kernel (games/kernels.py) on ``G`` games of the
    board ``spec`` (a BoardSpec): ``action_bytes`` the width of
    ``reversi_play``'s action, ``nvict`` the line games' run length."""
    board = spec.nwords * 8
    steps = 8 * (spec.rows - 1) * spec.nwords
    if kernel == "reversi_play":
        return Cost(G * (2 * board + action_bytes + 1) + G * (3 * board + 1),
                    G * 2 * steps)
    if kernel == "reversi_is_over":
        return Cost(G * (3 * board + 1) + G * 2, G * steps)
    if kernel == "line_is_over":
        return Cost(G * (2 * board + 1) + G * 2,
                    G * 4 * max(nvict - 1, 0) * spec.nwords)
    if kernel == "hex_is_over":
        # the previous mover's board and player; 2N-2 flood steps of
        # HEX_OPS_PER_WORD a word (three shifts, their masks, the step's
        # and-or, the re-seed)
        return Cost(G * (board + 1) + G * 2,
                    G * (2 * spec.rows - 4) * spec.nwords * HEX_OPS_PER_WORD)
    raise ValueError(f"{kernel}: not a rules kernel")
