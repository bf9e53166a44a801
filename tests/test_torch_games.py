"""The port's bitboards and connect4 rules against the reference, exactly:
the same random boards and random game trajectories (numpy seeds) go
through ``alphatpu.bitboard`` / ``alphatpu.games.connect4`` and their
torch counterparts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu import bitboard as jbb
from alphatpu.games import make_game as jax_make_game
from alphatpu_torch import bitboard as bb
from alphatpu_torch.games import make_game

SPECS = [(6, 7), (3, 3), (8, 8), (13, 13)]


def _random_boards(rng, spec, n):
    words = rng.integers(0, 1 << 32, size=(n, spec.nwords), dtype=np.uint64)
    return (words & spec.valid_mask.astype(np.uint64)).astype(np.uint32)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("rows,cols", SPECS)
def test_bitboard_ops_match_reference(rows, cols):
    rng = np.random.default_rng(rows * 100 + cols)
    jspec = jbb.BoardSpec(rows, cols)
    spec = bb.BoardSpec(rows, cols)
    b = _random_boards(rng, jspec, 256)
    jb, tb = jnp.asarray(b), torch.from_numpy(b.astype(np.int64))

    for n in sorted({1, 2, rows, rows + 1, 31, 32, 33, 64}):
        _eq(bb.shift_up_bits(spec, tb, n), jbb.shift_up_bits(jspec, jb, n))
        _eq(bb.shift_down_bits(spec, tb, n), jbb.shift_down_bits(jspec, jb, n))
    for name in ("right", "left", "down", "up", "invert"):
        _eq(getattr(bb, name)(spec, tb), getattr(jbb, name)(jspec, jb))
    _eq(bb.popcount(spec, tb), jbb.popcount(jspec, jb))
    _eq(bb.to_planes(spec, tb, torch.int32),
        jbb.to_planes(jspec, jb, jnp.int32))
    _eq(bb.from_planes(spec, bb.to_planes(spec, tb)), jb)

    # per-board cell indices, including -1 (which sets nothing)
    idx = rng.integers(-1, spec.nbits, size=256)
    ti = torch.from_numpy(idx)
    _eq(bb.set_bit(spec, tb, ti),
        jax.vmap(lambda x, i: jbb.set_bit(jspec, x, i))(jb, jnp.asarray(idx)))
    ok = idx >= 0
    _eq(bb.get_bit(spec, tb[ok], ti[ok]),
        jax.vmap(lambda x, i: jbb.get_bit(jspec, x, i))(
            jb[ok], jnp.asarray(idx[ok])))
    coords = [(0, 0), (rows - 1, cols - 1), (rows // 2, cols // 2)]
    np.testing.assert_array_equal(bb.from_coords(spec, coords),
                                  jbb.from_coords(jspec, coords))
    assert bb.popcount_words(torch.tensor([0xFFFFFFFF, 0, 1 << 31])).tolist() \
        == [32, 0, 1]


def _jax_state(state):
    return type(state)(*(np.asarray(x) for x in state))


def _eq_state(port, ref):
    for p, r in zip(port, ref):
        _eq(p, r)


def test_connect4_random_trajectories_match_reference():
    """256 random games of connect4 played to the end (and a few plies
    past it): every rule agrees with the reference at every ply."""
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    G = 256
    rng = np.random.default_rng(0)
    jlegal = jax.jit(jax.vmap(jgame.legal_mask))
    jplay = jax.jit(jax.vmap(jgame.play))
    jover = jax.jit(jax.vmap(jgame.is_over))
    jenc = jax.jit(jax.vmap(jgame.encode))
    jfeat = jax.jit(jax.vmap(jgame.final_feature))

    single = jgame.initial()
    jpos = jax.tree.map(lambda x: jnp.broadcast_to(x, (G,) + x.shape), single)
    pos = game.initial(G)
    _eq_state(pos, jpos)
    finished = np.zeros(G, bool)
    for ply in range(game.max_game_length + 2):
        legal = np.asarray(jlegal(jpos))
        np.testing.assert_array_equal(game.legal_mask(pos).numpy(), legal)
        done, result = jover(jpos)
        tdone, tresult = game.is_over(pos)
        _eq(tdone, done)
        _eq(tresult, result)
        finished |= np.asarray(done)
        _eq(game.encode(pos), jenc(jpos))
        _eq(game.final_feature(pos), jfeat(jpos))
        # a random legal column (column 0 on a full board)
        scores = np.where(legal, rng.random(legal.shape), -1.0)
        action = scores.argmax(1).astype(np.int32)
        jpos = jplay(jpos, jnp.asarray(action))
        pos = game.play(pos, torch.from_numpy(action))
        _eq_state(pos, jpos)
    assert finished.all()
    assert game.encode(pos).dtype == torch.float32
    assert game.final_feature(pos).dtype == torch.int8


def test_make_game_registry():
    assert make_game("Connect4").name == "connect4"
    for name in ("tictactoe", "gobang9", "hex7", "reversi6x6", "reversi8x8"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_game(name)
    with pytest.raises(ValueError, match="unknown game"):
        make_game("chess")
