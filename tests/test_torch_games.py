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
from alphatpu import oracles
from alphatpu.games import make_game as jax_make_game
from alphatpu_torch import bitboard as bb
from alphatpu_torch.games import make_game

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

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


@pytest.mark.parametrize("rows,cols", SPECS + [(14, 14), (8, 6)])
def test_shift_every_distance_matches_reference(rows, cols):
    """bitboard's word shifts at every distance from 0 past the board's
    size, up and down, and the composed diagonal moves equal the
    reference's on random boards; (14, 14) is hex13's board, 196 bits in
    seven words."""
    jspec, spec = jbb.BoardSpec(rows, cols), bb.BoardSpec(rows, cols)
    rng = np.random.default_rng(rows * 31 + cols)
    b = _random_boards(rng, jspec, 64)
    jb, tb = jnp.asarray(b), torch.from_numpy(b.astype(np.int64))
    for n in range(spec.nbits + 2):
        _eq(bb.shift_up_bits(spec, tb, n), jbb.shift_up_bits(jspec, jb, n))
        _eq(bb.shift_down_bits(spec, tb, n), jbb.shift_down_bits(jspec, jb, n))
    for v in ("up", "down"):
        for h in ("left", "right"):
            _eq(getattr(bb, v)(spec, getattr(bb, h)(spec, tb)),
                getattr(jbb, v)(jspec, getattr(jbb, h)(jspec, jb)))
    cells = rng.integers(0, spec.nbits, size=64)
    _eq(bb.cell_onehot(spec, torch.from_numpy(cells)),
        jax.vmap(lambda i: jbb.cell_onehot(jspec, i))(jnp.asarray(cells)))


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
    """Every family builds by name, with the reference's sizes; an unknown
    name raises ValueError."""
    sizes = {"connect4": (7, 42), "tictactoe": (9, 9), "gobang9": (81, 81),
             "gobang13": (169, 169), "hex7": (49, 64), "hex13": (169, 196),
             "reversi6x6": (37, 36), "reversi6": (37, 36),
             "reversi8x8": (65, 64), "reversi8": (65, 64),
             "reversi": (65, 64)}
    for name, (actions, cells) in sizes.items():
        game, jgame = make_game(name), jax_make_game(name)
        assert (game.max_actions, game.vectorized_state) == (actions, cells)
        for attr in ("name", "max_actions", "vectorized_state", "feature_size",
                     "max_game_length", "min_game_length"):
            assert getattr(game, attr) == getattr(jgame, attr), (name, attr)
    assert make_game("Connect4").name == "connect4"
    assert make_game("gobang9").nvict == 5 and make_game("gobang5").nvict == 5
    assert make_game("gobang9", nvict=4).nvict == 4
    assert make_game("gobang7").nvict == 7
    for name in ("chess", "gobang", "hex", "reversi7x7"):
        with pytest.raises(ValueError, match="unknown game.*gobang<N>"):
            make_game(name)
    for name in ("hex7", "tictactoe", "reversi"):
        with pytest.raises(ValueError, match="gobang<N> option"):
            make_game(name, nvict=4)


# name -> (port/JAX game kwargs, oracle)
FAMILIES = {
    "tictactoe": ({}, lambda: oracles.OracleGobang(3, 3)),
    "gobang9": ({"nvict": 5}, lambda: oracles.OracleGobang(9, 5)),
    "gobang13": ({}, lambda: oracles.OracleGobang(13, 5)),
    "hex5": ({}, lambda: oracles.OracleHex(5)),
    "hex7": ({}, lambda: oracles.OracleHex(7)),
    "hex13": ({}, lambda: oracles.OracleHex(13)),
    "reversi6x6": ({}, lambda: oracles.OracleReversi(6)),
    "reversi8x8": ({}, lambda: oracles.OracleReversi(8)),
    "connect4": ({}, lambda: oracles.OracleConnect4()),
    "gobang8": ({}, lambda: oracles.OracleGobang(8, 5)),
}
# games whose random moves avoid completing a line, and then moves that
# leave the opponent a winning reply, where another move exists: many end
# on a full board (a draw)
FULL_BOARDS = ("connect4", "gobang8")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_game_random_trajectories_match_reference(name):
    """16 random games played to the end and two plies past it: at every
    ply the port's legal_mask, play, is_over, encode and final_feature equal
    the JAX game's exactly, and on 4 of the games the independent numpy
    oracle's legal moves, planes and results.  Reversi's games pass; the
    games of ``FULL_BOARDS`` fill their boards."""
    kwargs, make_oracle = FAMILIES[name]
    jgame, game = jax_make_game(name, **kwargs), make_game(name, **kwargs)
    oracle = make_oracle()
    G, n_oracle = 16, 4
    rng = np.random.default_rng(sum(map(ord, name)))

    @jax.jit
    def jstep(pos, action):
        pos = jax.vmap(jgame.play)(pos, action)
        return pos, jax.vmap(jgame.is_over)(pos)

    acts = jnp.arange(jgame.max_actions, dtype=jnp.int32)

    def wins(p):
        """bool[A]: each move's position, and whether it wins for the
        mover."""
        after = jax.vmap(lambda a: jgame.play(p, a))(acts)
        return after, jax.vmap(jgame.is_over)(after)[1] != 0

    @jax.jit
    def jwinning(pos):
        """bool[G, A] twice: the move wins for the mover; after the move
        the opponent has a winning reply."""
        def one(p):
            after, win = wins(p)
            reply = jax.vmap(lambda q: (wins(q)[1] & jgame.legal_mask(q))
                             .any())(after)
            return win, reply
        return jax.vmap(one)(pos)

    @jax.jit
    def jinspect(pos):
        return (jax.vmap(jgame.legal_mask)(pos), jax.vmap(jgame.encode)(pos),
                jax.vmap(jgame.final_feature)(pos))

    single = jgame.initial()
    jpos = jax.tree.map(lambda x: jnp.broadcast_to(x, (G,) + x.shape), single)
    pos = game.initial(G)
    _eq_state(pos, jpos)
    ost = [oracle.initial() for _ in range(n_oracle)]
    odone = np.zeros(n_oracle, bool)
    finished = np.zeros(G, bool)
    results, passes, extra = np.zeros(G, np.int64), 0, 0
    vs = game.vectorized_state
    for ply in range(3 * max(game.max_actions, game.max_game_length)):
        legal, enc, feat = jinspect(jpos)
        legal = np.asarray(legal)
        np.testing.assert_array_equal(game.legal_mask(pos).numpy(), legal)
        _eq(game.encode(pos), enc)
        _eq(game.final_feature(pos), feat)
        for g in np.flatnonzero(~odone):
            mover, other = oracle.planes(ost[g])
            assert np.flatnonzero(legal[g]).tolist() == \
                oracle.legal_actions(ost[g]), (g, ply)
            np.testing.assert_array_equal(np.asarray(enc)[g, :vs], mover)
            np.testing.assert_array_equal(np.asarray(enc)[g, vs:], other)
        # a random legal action (0 where none is legal)
        scores = np.where(legal, rng.random(legal.shape), -9.0)
        if name in FULL_BOARDS:
            win, reply = (legal & np.asarray(x) for x in jwinning(jpos))
            scores -= 1.5 * win + 3.0 * reply
        action = scores.argmax(1).astype(np.int32)
        passes += int((action[~finished] == game.max_actions - 1).sum()
                      if name.startswith("reversi") else 0)
        jpos, (jdone, jresult) = jstep(jpos, jnp.asarray(action))
        pos = game.play(pos, torch.from_numpy(action))
        _eq_state(pos, jpos)
        done, result = game.is_over(pos)
        _eq(done, jdone)
        _eq(result, jresult)
        new = np.asarray(jdone) & ~finished
        results[new] = np.asarray(jresult)[new]
        finished |= np.asarray(jdone)
        for g in np.flatnonzero(~odone):
            ost[g] = oracle.play(ost[g], int(action[g]))
            o_done, o_result = oracle.is_over(ost[g])
            assert bool(done[g]) == bool(o_done), (g, ply)
            if o_done:
                assert int(result[g]) == int(o_result), (g, ply)
                odone[g] = True
        extra += int(finished.all())
        if extra > 2:
            break
    assert finished.all() and odone.all()
    if name.startswith("hex"):
        # every game ended through the flood reaching the corner
        assert set(np.unique(results)) <= {-1, 1}
    if name.startswith("reversi"):
        assert passes > 0, "no pass was played"
    if name in FULL_BOARDS:
        full = bb.popcount(game.spec, pos.bplayer | pos.bopponent) == \
            game.spec.nbits
        assert int(full.sum()) > 0 and (results == 0).any()
