"""The game rules the search runs on every rollout, as CUDA kernels: the
kernel wrappers with their launch counters, and the plain torch version of
each.

Four kernels, written by hand in CUDA C++ for Hopper
(``alphatpu_torch/csrc/rules.cu``), none of which replaces a Pallas
kernel.  The reference writes each rule as a static Python loop of ``jnp``
bit operations that is traced into its one jitted search program, where
XLA fuses each chain into a few loop fusions; run op by op, the same rule
costs the port hundreds of launches a call.  These kernels are the port's
counterpart of that fusion:

* :func:`reversi_play` - ``Reversi.play`` (``alphatpu/games/reversi.py``
  ``play``, ``flip_board``, ``legal_board``): the flips of the placed disc
  (the pass action, index ``size*size`` and above, places and flips
  nothing), the swap of sides and the new mover's legal board,
* :func:`reversi_is_over` - ``Reversi.is_over``: done when neither side
  can move, the sign of the disc difference times ``player``; the
  opponent's legal board is computed only for the warps where some
  mover has no move,
* :func:`line_is_over` - ``Gobang.is_over`` and ``Connect4.is_over``
  (``Game._line_win``): ``nvict`` in a row along four directions, or a
  full board; ``-player`` on a win,
* :func:`hex_is_over` - ``Hex.is_over``: the bit-parallel connectivity
  flood from the previous mover's border, 2N-2 steps; a game of hex ends
  only by a connection, won by the previous mover.

Each wrapper runs its plain version (``*_plain``, the torch bodies the
games ran before) when - and only when - its boards lie on the CPU; on
CUDA tensors it launches the kernel or raises.  Outputs are allocated with
``torch.empty`` on the current stream and nothing is read back, so the
rules run inside captured CUDA graphs.  ``launches`` counts a wrapper's
launches; they join the search kernels' accounting
(``mcts.kernels.KERNELS``), so a replayed graph adds them too.

The geometry - rows, cols, words, ``nvict`` and the spec's three masks -
comes from the :class:`~alphatpu_torch.bitboard.BoardSpec`
(:func:`reversi_geometry`, :func:`line_geometry`, :func:`hex_geometry`),
and the launch from plain Python: ``reversi_play``, ``reversi_is_over``
and ``line_is_over`` run four warps a block of 32 games, a warp a
direction or a pair of them (:func:`direction_geometry`),
``hex_is_over`` a game over lanes of a warp, a lane a word
(:func:`spread_geometry`); the C entry points refuse any other.
Boards are the port's: 32-bit words in int64 elements, cell ``(r, c)``
at bit ``r + rows * c``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import bitboard as bb
from .._build import launch as _launch
from .._build import on_cuda as _on_cuda

NUM_SMS = 132  # H100 SXM
RULES_THREADS = 128  # most threads a block of a rules kernel
DIRECTION_WARPS = 4  # the reversi and line kernels: a warp a direction (pair)
DIRECTION_GAMES = 32  # a lane a game in each warp
REVERSI_SIZES = (6, 8)
LINE_MAX_WORDS = 6  # gobang13's 169 cells
HEX_SIZES = range(2, 14)  # hex<N>: hex13's (N+1)^2 = 196 cells, 7 words
HEX_MAX_WORDS = 7


class RulesGeometry(NamedTuple):
    """A board the rules kernels take: its shape, its words, ``nvict``
    (line games; 0 for reversi) and the spec's masks, one 32-bit value a
    word each: valid cells, not the first row, not the last row."""

    rows: int
    cols: int
    words: int
    nvict: int
    masks: tuple


def _geometry(spec: bb.BoardSpec, nvict: int) -> RulesGeometry:
    masks = tuple(int(w) for m in (spec.valid_mask, spec.not_first_row_mask,
                                   spec.not_last_row_mask) for w in m)
    return RulesGeometry(spec.rows, spec.cols, spec.nwords, nvict, masks)


@functools.cache
def reversi_geometry(spec: bb.BoardSpec) -> RulesGeometry:
    """The geometry of a reversi board: square, 6x6 or 8x8 (two words)."""
    if spec.rows != spec.cols or spec.rows not in REVERSI_SIZES:
        raise ValueError(f"reversi kernels: a {spec.rows}x{spec.cols} board;"
                         f" they take square boards of sizes {REVERSI_SIZES}")
    return _geometry(spec, 0)


@functools.cache
def line_geometry(spec: bb.BoardSpec, nvict: int) -> RulesGeometry:
    """The geometry of a line game's board: up to ``LINE_MAX_WORDS`` words,
    rows and columns from 1 to 31 (a shift stays inside a word and its
    neighbour), ``nvict`` from 1 to 32."""
    if not (1 <= spec.nwords <= LINE_MAX_WORDS and 1 <= spec.rows <= 31
            and 1 <= spec.cols <= 31 and 1 <= nvict <= 32):
        raise ValueError(f"line_is_over: a {spec.rows}x{spec.cols} board "
                         f"({spec.nwords} words), nvict {nvict}; the kernel "
                         f"takes up to {LINE_MAX_WORDS} words, rows and cols "
                         "up to 31, nvict 1-32")
    return _geometry(spec, nvict)


@functools.cache
def hex_geometry(spec: bb.BoardSpec) -> RulesGeometry:
    """The geometry of a hex board: N from 2 to 13, embedded in a square
    of N+1 rows (the border), 1 to 7 words."""
    if spec.rows != spec.cols or spec.rows - 1 not in HEX_SIZES:
        raise ValueError(f"hex_is_over: a {spec.rows}x{spec.cols} board; "
                         f"the kernel takes hex<N> for N in {HEX_SIZES.start}"
                         f"-{HEX_SIZES.stop - 1}, (N+1)x(N+1) embedded")
    return _geometry(spec, 0)


def _block_threads(G: int, lanes: int) -> int:
    """``RULES_THREADS``, halved down to one warp while that leaves SMs
    without a block (``lanes`` threads a game)."""
    if G < 1:
        raise ValueError(f"rules kernels: G={G} < 1")
    threads = RULES_THREADS
    while threads > 32 and -(-G * lanes // threads) < NUM_SMS:
        threads //= 2
    return threads


class DirectionGeometry(NamedTuple):
    """The launch of ``reversi_play``, ``reversi_is_over`` and
    ``line_is_over``."""

    threads: int  # a block: DIRECTION_WARPS warps
    blocks: int  # exactly those that cover G games, DIRECTION_GAMES each


def direction_geometry(G: int) -> DirectionGeometry:
    """The launch of ``reversi_play``, ``reversi_is_over`` and
    ``line_is_over``: blocks of ``DIRECTION_WARPS`` warps that share
    ``DIRECTION_GAMES`` games, lane ``l`` of every warp game ``l`` of the
    block, warp ``k`` the line games' direction ``k`` or reversi's
    directions ``2k`` and ``2k+1``; the fewest blocks that cover ``G``
    games (at 2048 games 64 blocks, 256 warps)."""
    if G < 1:
        raise ValueError(f"direction_geometry: G={G} < 1")
    return DirectionGeometry(DIRECTION_WARPS * 32, -(-G // DIRECTION_GAMES))


class SpreadGeometry(NamedTuple):
    """The launch of ``hex_is_over``, a game over lanes of a warp."""

    lanes: int  # a game's lanes of one warp
    threads: int  # a block
    blocks: int  # exactly those that cover G games


def spread_geometry(words: int, G: int) -> SpreadGeometry:
    """``hex_is_over``'s launch: a game's lanes of one warp, the next
    power of two at or above the board's ``words`` (1, 2, 4 or 8), a lane
    a word, in blocks of ``RULES_THREADS`` threads halved down to one warp
    while that leaves SMs without a block."""
    if G < 1:
        raise ValueError(f"spread_geometry: G={G} < 1")
    if not 1 <= words <= HEX_MAX_WORDS:
        raise ValueError(f"spread_geometry: hex_is_over on {words} words, "
                         f"expected 1-{HEX_MAX_WORDS}")
    lanes = 1 << (words - 1).bit_length()
    threads = _block_threads(G, lanes)
    return SpreadGeometry(lanes, threads, -(-G // (threads // lanes)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def reversi_dirs(spec: bb.BoardSpec):
    """The eight directions: up, down, left, right, up-left, down-left,
    up-right, down-right."""
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


def legal_board_plain(spec: bb.BoardSpec, me: torch.Tensor,
                      adv: torch.Tensor) -> torch.Tensor:
    """Bitboard of the placing moves of ``me``."""
    emptyc = bb.invert(spec, me | adv)
    out = torch.zeros_like(me)
    for d in reversi_dirs(spec):
        cand = d(me) & adv
        for _ in range(spec.rows - 2):
            dc = d(cand)
            out = out | (emptyc & dc)
            cand = adv & dc
        out = out | (emptyc & d(cand))
    return out


def flip_board_plain(spec: bb.BoardSpec, me, adv, played) -> torch.Tensor:
    """The discs of ``adv`` that a disc on ``played`` (a board) flips."""
    out = torch.zeros_like(me)
    for d in reversi_dirs(spec):
        cand = d(played) & adv
        toflip = cand
        for _ in range(spec.rows - 2):
            cand = adv & d(cand)
            toflip = toflip | cand
        capped = (d(toflip) & me).any(-1, keepdim=True)
        out = out | torch.where(capped, toflip, 0)
    return out


def reversi_play_plain(spec: bb.BoardSpec, bplayer, bopponent, player,
                       action):
    """``(bplayer, bopponent, legal, player)`` after each game's
    ``action``: the sides swapped, the new mover's legal board."""
    cells = spec.rows * spec.cols
    is_pass = (action >= cells)[:, None]
    placed = bb.cell_onehot(spec, torch.where(is_pass[:, 0], 0, action))
    h = flip_board_plain(spec, bplayer, bopponent, placed)
    h = torch.where(is_pass, 0, h)
    placed = torch.where(is_pass, 0, placed)
    me = (bplayer ^ h) | placed
    adv = bopponent ^ h
    return adv, me, legal_board_plain(spec, adv, me), -player


def reversi_is_over_plain(spec: bb.BoardSpec, bplayer, bopponent, legal,
                          player):
    """(bool[G] done, int8[G] result)."""
    opp_moves = legal_board_plain(spec, bopponent, bplayer)
    done = (legal == 0).all(-1) & (opp_moves == 0).all(-1)
    diff = bb.popcount(spec, bplayer) - bb.popcount(spec, bopponent)
    result = torch.sign(diff).to(torch.int8) * player
    return done, torch.where(done, result, 0).to(torch.int8)


def line_win_plain(spec: bb.BoardSpec, board: torch.Tensor,
                   nvict: int) -> torch.Tensor:
    """bool[G]: ``nvict`` stones in a row on ``board`` along any of the
    four directions (``nvict - 1`` shift-ANDs per direction)."""
    win = torch.zeros(board.shape[:-1], dtype=torch.bool,
                      device=board.device)
    for step in (
        lambda x: bb.right(spec, x),
        lambda x: bb.down(spec, x),
        lambda x: bb.down(spec, bb.right(spec, x)),
        lambda x: bb.left(spec, bb.down(spec, x)),
    ):
        b = board
        for _ in range(nvict - 1):
            b = b & step(b)
        win = win | (bb.popcount(spec, b) != 0)
    return win


def line_is_over_plain(spec: bb.BoardSpec, nvict: int, bplayer, bopponent,
                       player):
    """(bool[G] done, int8[G] result): the previous mover (``bopponent``)
    has ``nvict`` in a row, or the board is full."""
    win = line_win_plain(spec, bopponent, nvict)
    full = (bb.popcount(spec, bplayer) + bb.popcount(spec, bopponent)
            == spec.rows * spec.cols)
    done = win | full
    # the winner is the previous mover
    result = torch.where(win, -player, 0).to(torch.int8)
    return done, result


@functools.lru_cache(maxsize=None)
def hex_seeds(spec: bb.BoardSpec, device) -> torch.Tensor:
    """i64[2N-2, words]: the flood's re-seed at step j = 1 .. 2N-2, the
    row-0 border from column 2+j to N."""
    n = spec.rows - 1
    return torch.as_tensor(np.array([
        bb.from_coords(spec, [(0, c) for c in range(2 + j, n + 1)])
        for j in range(1, 2 * n - 1)], dtype=np.int64).reshape(
            -1, spec.nwords), device=device)


def hex_is_over_plain(spec: bb.BoardSpec, n: int, bopponent, player):
    """(bool[G] done, int8[G] result): the flood of ``a = down((a & (b|c))
    | (b & c))`` with ``b = up(a)``, ``c = right(b)`` from the previous
    mover's stones (border included), 2N-2 steps, re-seeding part of row
    0 at each step when the previous mover owns that border
    (``player == 1``); won where the bottom-right corner is reached."""
    a = bopponent
    reseed = (player == 1)[:, None]
    seeds = hex_seeds(spec, a.device)
    for j in range(2 * n - 2):
        b = bb.up(spec, a)
        c = bb.right(spec, b)
        a = bb.down(spec, (a & (b | c)) | (b & c))
        a = torch.where(reseed, a | seeds[j], a)
    corner = spec.nbits - 1  # (row N, column N)
    win = ((a[:, corner // bb.WORD_BITS] >> corner % bb.WORD_BITS) & 1) != 0
    return win, torch.where(win, -player, 0).to(torch.int8)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_boards(kernel, geo: RulesGeometry, boards, player):
    """Every board i64[G, words] on one CUDA device and ``player`` i8[G];
    returns (G, device).  A strided board is copied to a contiguous one."""
    G, dev = player.shape[0], player.device
    for name, t in boards:
        if t.device != dev or t.dtype != bb.WORD_DTYPE or \
                tuple(t.shape) != (G, geo.words):
            raise ValueError(f"{kernel}: {name} {t.dtype}{tuple(t.shape)} on"
                             f" {t.device}, expected {bb.WORD_DTYPE}"
                             f"({G}, {geo.words}) on {dev}")
    if player.dtype != torch.int8 or player.dim() != 1:
        raise ValueError(f"{kernel}: player {player.dtype}"
                         f"{tuple(player.shape)}, expected int8[G]")
    return G, dev


def _masks(geo: RulesGeometry):
    """The masks as a host array the C entry reads at launch."""
    return (ctypes.c_uint32 * len(geo.masks))(*geo.masks)


def reversi_play(spec: bb.BoardSpec, bplayer, bopponent, player, action):
    """``Reversi.play`` on boards i64[G, 2] and ``player`` i8[G] with
    ``action`` i32/i64[G]: ``(bplayer, bopponent, legal, player)``, new
    tensors."""
    action = torch.as_tensor(action, device=bplayer.device)
    if not _on_cuda("reversi_play", bplayer):
        return reversi_play_plain(spec, bplayer, bopponent, player,
                                  action.long())
    geo = reversi_geometry(spec)
    G, dev = _check_boards("reversi_play", geo, (("bplayer", bplayer),
                                                 ("bopponent", bopponent)),
                           player)
    if action.dtype not in (torch.int32, torch.int64) or \
            tuple(action.shape) != (G,) or action.device != dev:
        raise ValueError(f"reversi_play: action {action.dtype}"
                         f"{tuple(action.shape)} on {action.device}, "
                         f"expected int32/int64[{G}] on {dev}")
    out = tuple(torch.empty((G, geo.words), dtype=bb.WORD_DTYPE, device=dev)
                for _ in range(3)) + (torch.empty((G,), dtype=torch.int8,
                                                  device=dev),)
    _launch("launch_reversi_play", dev, bplayer.contiguous(),
            bopponent.contiguous(), action.contiguous(),
            player.contiguous(), *out, _masks(geo), G,
            action.element_size() * 8, geo.rows, geo.cols, geo.words,
            *direction_geometry(G))
    reversi_play.launches += 1
    return out


def reversi_is_over(spec: bb.BoardSpec, bplayer, bopponent, legal, player):
    """``Reversi.is_over`` on boards i64[G, 2] and ``player`` i8[G]:
    (bool[G] done, int8[G] result)."""
    if not _on_cuda("reversi_is_over", bplayer):
        return reversi_is_over_plain(spec, bplayer, bopponent, legal, player)
    geo = reversi_geometry(spec)
    G, dev = _check_boards("reversi_is_over", geo,
                           (("bplayer", bplayer), ("bopponent", bopponent),
                            ("legal", legal)), player)
    done = torch.empty((G,), dtype=torch.bool, device=dev)
    result = torch.empty((G,), dtype=torch.int8, device=dev)
    _launch("launch_reversi_is_over", dev, bplayer.contiguous(),
            bopponent.contiguous(), legal.contiguous(), player.contiguous(),
            done, result, _masks(geo), G, geo.rows, geo.cols, geo.words,
            *direction_geometry(G))
    reversi_is_over.launches += 1
    return done, result


def line_is_over(spec: bb.BoardSpec, nvict: int, bplayer, bopponent,
                 player):
    """``Gobang.is_over`` / ``Connect4.is_over`` on boards i64[G, words]
    and ``player`` i8[G]: (bool[G] done, int8[G] result)."""
    if not _on_cuda("line_is_over", bplayer):
        return line_is_over_plain(spec, nvict, bplayer, bopponent, player)
    geo = line_geometry(spec, nvict)
    G, dev = _check_boards("line_is_over", geo, (("bplayer", bplayer),
                                                 ("bopponent", bopponent)),
                           player)
    done = torch.empty((G,), dtype=torch.bool, device=dev)
    result = torch.empty((G,), dtype=torch.int8, device=dev)
    _launch("launch_line_is_over", dev, bplayer.contiguous(),
            bopponent.contiguous(), player.contiguous(), done, result,
            _masks(geo), G, geo.rows, geo.cols, geo.words, geo.nvict,
            *direction_geometry(G))
    line_is_over.launches += 1
    return done, result


def hex_is_over(spec: bb.BoardSpec, n: int, bopponent, player):
    """``Hex.is_over`` on the previous mover's board i64[G, words] and
    ``player`` i8[G]: (bool[G] done, int8[G] result)."""
    if not _on_cuda("hex_is_over", bopponent):
        return hex_is_over_plain(spec, n, bopponent, player)
    geo = hex_geometry(spec)
    if n != geo.rows - 1:
        raise ValueError(f"hex_is_over: hex{n} on a {geo.rows}x{geo.cols} "
                         "board")
    G, dev = _check_boards("hex_is_over", geo, (("bopponent", bopponent),),
                           player)
    done = torch.empty((G,), dtype=torch.bool, device=dev)
    result = torch.empty((G,), dtype=torch.int8, device=dev)
    _launch("launch_hex_is_over", dev, bopponent.contiguous(),
            player.contiguous(), done, result, _masks(geo), G, geo.rows,
            geo.cols, geo.words, *spread_geometry(geo.words, G))
    hex_is_over.launches += 1
    return done, result


RULES = (reversi_play, reversi_is_over, line_is_over, hex_is_over)
for _k in RULES:
    _k.launches = _k.launches_bf16 = 0


def rules_owed(game, calls: int) -> dict:
    """The rules launches that ``calls`` calls of ``game.play`` and as
    many of ``game.is_over`` on the card owe, by wrapper (the wrappers
    ``game`` does not call owe 0).  Every path calls the two alike: once
    a rollout and once a move."""
    owed = {k.__name__: 0 for k in RULES}
    for name in (game.play_kernel, game.is_over_kernel):
        if name:
            owed[name] += calls
    return owed


def sample_positions(game, G: int, seed: int, device=None):
    """``G`` positions of ``game`` and an action for each, drawn with numpy
    from ``seed``: the inputs on which the rules kernels are held to their
    plain versions.  Each lane plays random legal moves (and, once its
    game is over, any action in ``[0, max_actions)``, as the duel's and
    the evaluations' dead lanes do) up to a random ply; the last eighth
    are full boards, every cell given to one side at random.  The action
    is a legal one on half the lanes and any in ``[0, max_actions)`` on the
    other half; on reversi a quarter of them pass.  Returns
    ``(positions, action i64[G])`` on ``device``, made on the CPU."""
    from .base import where_games

    rng = np.random.default_rng(seed)
    pos = game.initial(G)
    stop = rng.integers(0, game.max_game_length + 3, size=G)

    def draw(pos):
        legal = game.legal_mask(pos).numpy()
        pick = np.where(legal, rng.random(legal.shape), -1.0).argmax(1)
        return legal, pick, rng.integers(0, game.max_actions, size=G)

    for ply in range(game.max_game_length + 2):
        done = game.is_over(pos)[0].numpy()
        _, pick, anything = draw(pos)
        action = np.where(done, anything, pick)
        pos = where_games(torch.from_numpy(ply < stop),
                          game.play(pos, torch.from_numpy(action)), pos)
    full = np.arange(G) >= G - G // 8
    cells = torch.from_numpy(rng.random((G, game.spec.nbits)) < 0.5)
    mine, theirs = (bb.from_planes(game.spec, c) for c in (cells, ~cells))
    mask = torch.from_numpy(full)[:, None]
    fields = pos._asdict()
    fields["bplayer"] = torch.where(mask, mine, pos.bplayer)
    fields["bopponent"] = torch.where(mask, theirs, pos.bopponent)
    if "legal" in fields:
        fields["legal"] = torch.where(
            mask, legal_board_plain(game.spec, mine, theirs), pos.legal)
    pos = type(pos)(**fields)
    _, pick, anything = draw(pos)
    action = np.where(rng.random(G) < 0.5, pick, anything)
    if game.play_kernel == "reversi_play":
        action = np.where(rng.random(G) < 0.25, game.max_actions - 1, action)
    return (type(pos)(*(x.to(device) for x in pos)),
            torch.from_numpy(action).to(device))


def stuck_first(pos):
    """Reversi positions with their lanes reordered (a stable sort), the
    movers without a move first: blocks of 32 games in which every mover
    has a move, where ``reversi_is_over`` skips the opponent's chain,
    beside blocks that run it."""
    order = torch.argsort((pos.legal != 0).any(-1).to(torch.int8),
                          stable=True)
    return type(pos)(*(x[order] for x in pos))
