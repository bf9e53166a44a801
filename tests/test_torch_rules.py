"""The game rules' kernel wrappers (``alphatpu_torch.games.kernels``) on
the CPU: their plain versions against the reference's rules on sampled
positions (dead lanes, passes, full boards; hex's flood on hex5 to
hex13), the dispatch (CPU tensors take the plain path and count
nothing), the geometry each wrapper hands its kernel, and the launches a
path owes.  The kernels themselves are held
to the plain versions on the card (``tests/test_torch_port.py``,
``chip_smoke.py``)."""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.games import make_game as jax_make_game
from alphatpu_torch import bitboard as bb
from alphatpu_torch.games import kernels as R
from alphatpu_torch.games import make_game
from alphatpu_torch.mcts import bounds
from alphatpu_torch.mcts import kernels as K

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

GAMES = ("reversi6x6", "reversi8x8", "tictactoe", "connect4", "gobang8",
         "gobang9", "gobang13")
HEX_GAMES = ("hex5", "hex7", "hex11", "hex13")


@pytest.fixture(autouse=True)
def zero_counts():
    """Every test starts and ends with the launch counters at 0: the tests
    that stand in for a launch count it, and other files in the worker
    read the counters."""
    K.reset_launch_counts()
    yield
    K.reset_launch_counts()


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("name", GAMES)
def test_plain_rules_match_reference_on_sampled_positions(name):
    """On 64 sampled positions - lanes past their game's end given any
    action, reversi's pass, random full boards - the plain ``play`` and
    ``is_over`` equal the reference's, and so does ``is_over`` after the
    move."""
    game, jgame = make_game(name), jax_make_game(name)
    pos, action = R.sample_positions(game, 64, seed=len(name))
    jpos = type(pos)(*(jnp.asarray(x.numpy().astype(ref.dtype))
                       for x, ref in zip(pos, jgame.initial())))
    jaction = jnp.asarray(action.numpy().astype(np.int32))
    for got, want in zip(game.is_over(pos), jax.vmap(jgame.is_over)(jpos)):
        _eq(got, want)
    played = game.play(pos, action)
    jplayed = jax.vmap(jgame.play)(jpos, jaction)
    for got, want in zip(played, jplayed):
        _eq(got, want)
    for got, want in zip(game.is_over(played),
                         jax.vmap(jgame.is_over)(jplayed)):
        _eq(got, want)


@pytest.mark.parametrize("name", GAMES)
def test_sampled_positions_cover_the_hard_cases(name):
    """The sample holds finished games, full boards and, on reversi, the
    pass action on lanes that must pass and on lanes that need not."""
    game = make_game(name)
    pos, action = R.sample_positions(game, 256, seed=1)
    done, _ = game.is_over(pos)
    cells = game.spec.nbits
    stones = bb.popcount(game.spec, pos.bplayer | pos.bopponent)
    assert bool(done.any()) and bool((~done).any())
    assert int((stones == cells).sum()) >= 256 // 8
    assert int(action.min()) >= 0 and int(action.max()) < game.max_actions
    if name.startswith("reversi"):
        passing = action == game.max_actions - 1
        forced = (pos.legal == 0).all(-1)
        assert bool((passing & forced).any()) and bool((passing & ~forced)
                                                       .any())


def _joined(t):
    """A reversi board i64[G, 2] as one 64-bit value a game (the kernel's
    layout)."""
    w = t.numpy().astype(np.uint64)
    return w[:, 0] | (w[:, 1] << np.uint64(32))


def _split(x):
    return torch.from_numpy(np.stack([x & np.uint64(0xFFFFFFFF),
                                      x >> np.uint64(32)], 1).astype(np.int64))


def _shifted(spec, d):
    """``Reversi::shifted<d>`` in rules.cu: direction ``d``'s net shift,
    unmasked."""
    s = spec.rows
    shift = {0: -1, 1: 1, 2: -s, 3: s, 4: -(s + 1), 5: -(s - 1), 6: s - 1,
             7: s + 1}[d]
    return lambda x: (x << np.uint64(shift) if shift > 0
                      else x >> np.uint64(-shift))


def _fold(spec, d):
    """The reversi kernels' folded step: the net shift of direction ``d``
    and its mask, ``step(d, ~0)``."""
    full = _split(np.full(1, ~np.uint64(0), dtype=np.uint64))
    mask = _joined(R.reversi_dirs(spec)[d](full))[0]
    shifted = _shifted(spec, d)
    return (lambda x: shifted(x) & mask), mask


def _valid(spec):
    return _joined(_split(np.full(1, ~np.uint64(0), dtype=np.uint64))
                   & torch.tensor(spec.valid_mask)[None])[0]


def _legal_pair(spec, k, me, adv):
    """``Reversi::legal_pair``: directions ``2k`` and ``2k+1`` of the
    legal board of ``me``, each ``legal_dir`` with the kernel's unmasked
    shifts (adv and the empty cells masked once)."""
    emptyc = ~(me | adv) & _valid(spec)
    out = np.zeros_like(me)
    for d in (2 * k, 2 * k + 1):
        _, mask = _fold(spec, d)
        shifted = _shifted(spec, d)
        a, e = adv & mask, emptyc & mask
        cand = a & shifted(me)
        for _ in range(spec.rows - 2):
            dc = shifted(cand)
            out, cand = out | (e & dc), a & dc
        out = out | (e & shifted(cand))
    return out


def _reversi_is_over_model(spec, pos):
    """``reversi_is_over_kernel``'s arithmetic in numpy, lane by lane:
    each block of 32 lanes votes on "a mover without a move"; a block that
    votes no stores done False and result 0 without the chain, the others
    OR the four warps' pairs of the opponent's legal board."""
    bp, bo, legal = (_joined(t) for t in (pos.bplayer, pos.bopponent,
                                          pos.legal))
    G = len(bp)
    stuck = legal == 0
    vote = np.repeat(np.pad(stuck, (0, -G % 32)).reshape(-1, 32).any(1),
                     32)[:G]
    done = np.zeros(G, dtype=bool)
    opp = np.zeros(int(vote.sum()), dtype=np.uint64)
    for k in range(4):
        opp |= _legal_pair(spec, k, bo[vote], bp[vote])
    done[vote] = stuck[vote] & (opp == 0)
    diff = (np.bitwise_count(bp).astype(np.int64)
            - np.bitwise_count(bo).astype(np.int64))
    result = np.where(done, np.sign(diff) * pos.player.numpy(), 0)
    return done, result.astype(np.int8), vote


@pytest.mark.parametrize("d", range(8))
@pytest.mark.parametrize("name", ("reversi6x6", "reversi8x8"))
def test_reversi_step_folds_into_one_shift_and_mask(name, d):
    """Each of reversi's eight steps is up to two shifts, each then masked;
    a shift distributes over an AND, so the step equals its net shift
    masked by the step of a full board - on any 64-bit value, off-board
    bits included (reversi_play's kernel runs the steps so)."""
    spec = make_game(name).spec
    rng = np.random.default_rng(d)
    x = rng.integers(0, 2**63, size=4096, dtype=np.uint64) * np.uint64(2) \
        | rng.integers(0, 2, size=4096, dtype=np.uint64)
    x = np.concatenate([x, np.array([0, ~np.uint64(0)], dtype=np.uint64)])
    step, _ = _fold(spec, d)
    np.testing.assert_array_equal(
        step(x), _joined(R.reversi_dirs(spec)[d](_split(x))))


@pytest.mark.parametrize("name", ("reversi6x6", "reversi8x8"))
def test_folded_flips_and_legal_boards_equal_the_plain_ones(name):
    """reversi_play's per-direction flips and legal boards with the folded
    steps, ORed over the eight directions, equal ``flip_board_plain`` and
    ``legal_board_plain`` on sampled positions (the kernel's arithmetic,
    written out in numpy)."""
    game = make_game(name)
    spec = game.spec
    pos, action = R.sample_positions(game, 256, seed=9)
    me, adv = _joined(pos.bplayer), _joined(pos.bopponent)
    placed = _joined(bb.cell_onehot(spec, action.clamp(max=spec.nbits - 1)))
    emptyc = ~(me | adv) & _valid(spec)
    flips = legal = np.zeros_like(me)
    for d in range(8):
        step, mask = _fold(spec, d)
        a, e = adv & mask, emptyc & mask
        cand = toflip = a & step(placed)
        for _ in range(spec.rows - 2):
            cand = a & step(cand)
            toflip = toflip | cand
        flips = flips | np.where(step(toflip) & me != 0, toflip, 0)
        cand = a & step(me)
        for _ in range(spec.rows - 2):
            dc = step(cand)
            legal, cand = legal | (e & dc), a & dc
        legal = legal | (e & step(cand))
    want = R.flip_board_plain(spec, pos.bplayer, pos.bopponent,
                              _split(placed))
    np.testing.assert_array_equal(flips, _joined(want))
    want = R.legal_board_plain(spec, pos.bplayer, pos.bopponent)
    np.testing.assert_array_equal(legal, _joined(want))
    assert flips.any() and legal.any()


@pytest.mark.parametrize("seed", (3, 11, 29))
@pytest.mark.parametrize("name", ("reversi6x6", "reversi8x8"))
def test_folded_opponent_legal_board_equals_the_plain_one(name, seed):
    """reversi_is_over's opponent legal board - four pairs of directions,
    each ``legal_dir`` with one unmasked shift a step, ORed - equals
    ``legal_board_plain(bopponent, bplayer)`` on sampled positions and
    after their move (passes, dead lanes, full boards)."""
    game = make_game(name)
    spec = game.spec
    pos, action = R.sample_positions(game, 256, seed=seed)
    played = type(pos)(*R.reversi_play_plain(
        spec, pos.bplayer, pos.bopponent, pos.player, action))
    for p in (pos, played):
        me, adv = _joined(p.bopponent), _joined(p.bplayer)
        got = np.zeros_like(me)
        for k in range(4):
            got |= _legal_pair(spec, k, me, adv)
        want = R.legal_board_plain(spec, p.bopponent, p.bplayer)
        np.testing.assert_array_equal(got, _joined(want))
        assert got.any() and not got.all()


@pytest.mark.parametrize("seed", (3, 11, 29))
@pytest.mark.parametrize("name", ("reversi6x6", "reversi8x8"))
def test_reversi_is_over_skip_rule_equals_the_plain_one(name, seed):
    """A block of 32 lanes in which every mover has a move is not over
    and scores 0, so reversi_is_over skips the opponent's chain there: its
    model gives ``reversi_is_over_plain``'s done and result on every lane,
    before and after the move, with the lanes as sampled and with the
    movers without a move gathered first (blocks that skip beside blocks
    that do not, a partial last block)."""
    game = make_game(name)
    spec = game.spec
    G = 250  # eight blocks, the last one part full
    pos, action = R.sample_positions(game, G, seed=seed)
    played = type(pos)(*R.reversi_play_plain(
        spec, pos.bplayer, pos.bopponent, pos.player, action))
    votes = []
    for p in (pos, played):
        for q in (p, R.stuck_first(p)):
            done, result, vote = _reversi_is_over_model(spec, q)
            want = R.reversi_is_over_plain(spec, *q[:4])
            np.testing.assert_array_equal(done, want[0].numpy())
            np.testing.assert_array_equal(result, want[1].numpy())
            votes.append(vote)
    stones = bb.popcount(spec, pos.bplayer | pos.bopponent)
    assert bool((stones == spec.nbits).any()) and bool(
        (action == game.max_actions - 1).any())
    assert all(v.any() for v in votes) and not all(v.all() for v in votes)
    assert bool(R.reversi_is_over_plain(spec, *pos[:4])[0].any())


@pytest.mark.parametrize("name", HEX_GAMES)
def test_hex_flood_matches_reference_on_sampled_positions(name):
    """``hex_is_over_plain`` equals the reference's ``Hex.is_over``,
    vmapped, on every lane of 128 sampled positions and of the positions
    after each lane's action - won positions of both movers among them, so
    the flood runs with and without the row-0 re-seed."""
    game, jgame = make_game(name), jax_make_game(name)
    pos, action = R.sample_positions(game, 128, seed=len(name))
    played = game.play(pos, action)
    results = []
    for p in (pos, played):
        jp = type(p)(*(jnp.asarray(x.numpy().astype(ref.dtype))
                       for x, ref in zip(p, jgame.initial())))
        got = R.hex_is_over_plain(game.spec, game.n, p.bopponent, p.player)
        for g, w in zip(got, jax.vmap(jgame.is_over)(jp)):
            _eq(g, w)
        results.append(got[1])
    won = torch.cat(results)
    assert int((won == 1).sum()) and int((won == -1).sum())


@pytest.mark.parametrize("name", GAMES + ("hex7",))
def test_cpu_rules_take_the_plain_path(name):
    """On CPU tensors the four game methods run the plain versions: the
    same tensors as calling them directly, and no launch counted."""
    game = make_game(name)
    pos, action = R.sample_positions(game, 32, seed=2)
    K.reset_launch_counts()
    done, result = game.is_over(pos)
    played = game.play(pos, action)
    assert all(n == (0, 0) for n in K.launch_counts().values())
    if name.startswith("reversi"):
        want = R.reversi_is_over_plain(game.spec, pos.bplayer, pos.bopponent,
                                       pos.legal, pos.player)
        for got, ref in zip(played, R.reversi_play_plain(
                game.spec, pos.bplayer, pos.bopponent, pos.player, action)):
            assert torch.equal(got, ref)
    elif name.startswith("hex"):
        want = R.hex_is_over_plain(game.spec, game.n, pos.bopponent,
                                   pos.player)
    else:
        want = R.line_is_over_plain(game.spec, game.nvict, pos.bplayer,
                                    pos.bopponent, pos.player)
    assert torch.equal(done, want[0]) and torch.equal(result, want[1])


def test_launch_counts_name_the_rules_wrappers():
    """The rules wrappers join the search kernels' counters, so a graph
    replay adds their launches as it adds the walks'."""
    names = set(K.launch_counts())
    assert {"reversi_play", "reversi_is_over", "line_is_over",
            "hex_is_over"} <= names
    K.reset_launch_counts()
    K.add_launches({n: (3, 0) if n == "line_is_over" else (0, 0)
                    for n in names})
    assert R.line_is_over.launches == 3
    K.reset_launch_counts()
    assert R.line_is_over.launches == 0


def test_geometry_refuses_what_the_kernels_do_not_take():
    """Reversi: square 6x6 or 8x8 boards; line games: up to six words,
    rows and cols up to 31, nvict 1-32.  The masks are the spec's."""
    for rows, cols in ((7, 7), (8, 6), (4, 4)):
        with pytest.raises(ValueError, match="reversi kernels"):
            R.reversi_geometry(bb.BoardSpec(rows, cols))
    for rows, cols, nvict in ((14, 14, 5), (1, 32, 3), (9, 9, 0),
                              (9, 9, 33)):
        with pytest.raises(ValueError, match="line_is_over"):
            R.line_geometry(bb.BoardSpec(rows, cols), nvict)
    spec = bb.BoardSpec(6, 6)
    geo = R.reversi_geometry(spec)
    assert (geo.rows, geo.cols, geo.words, geo.nvict) == (6, 6, 2, 0)
    assert geo.masks == tuple(spec.valid_mask) + tuple(
        spec.not_first_row_mask) + tuple(spec.not_last_row_mask)
    assert geo.masks[:2] == (0xFFFFFFFF, 0xF)  # 36 cells over two words
    geo = R.line_geometry(bb.BoardSpec(13, 13), 5)
    assert (geo.words, geo.nvict, len(geo.masks)) == (6, 5, 18)
    # a game whose spec the kernel refuses raises on a CUDA tensor instead
    # of falling back (the check runs before any launch)
    with pytest.raises(ValueError, match="line_is_over"):
        R.line_geometry(make_game("hex13").spec, 5)
    # reversi_play's and line_is_over's launch needs a game
    with pytest.raises(ValueError, match="direction_geometry"):
        R.direction_geometry(0)


@pytest.mark.parametrize("n", range(2, 14))
def test_hex_geometry_covers_every_size(n):
    """Every hex<N> the registry plays at N from 2 to 13, one to seven
    words, with the spec's masks; a board of another size or shape is
    refused, so a CUDA tensor raises instead of falling back."""
    spec = make_game(f"hex{n}").spec
    geo = R.hex_geometry(spec)
    assert (geo.rows, geo.cols) == (n + 1, n + 1)
    assert geo.words == spec.nwords == -(-(n + 1) ** 2 // 32)
    assert geo.masks == tuple(spec.valid_mask) + tuple(
        spec.not_first_row_mask) + tuple(spec.not_last_row_mask)
    for rows, cols in ((n + 1, n + 2), (n + 2, n + 1)):
        with pytest.raises(ValueError, match="hex_is_over"):
            R.hex_geometry(bb.BoardSpec(rows, cols))
    if n == 2:
        assert geo.words == 1
        with pytest.raises(ValueError, match="hex_is_over"):
            R.hex_geometry(make_game("hex1").spec)
    if n == 13:
        assert geo.words == 7
        with pytest.raises(ValueError, match="hex_is_over"):
            R.hex_geometry(bb.BoardSpec(15, 15))  # hex14


@pytest.mark.parametrize("name", HEX_GAMES)
def test_hex_seeds_are_the_reference_borders(name):
    """The flood's re-seed at step j covers row 0 from column 2 + j to N,
    as the reference's ``Hex._seeds``."""
    game, jgame = make_game(name), jax_make_game(name)
    seeds = R.hex_seeds(game.spec, torch.device("cpu"))
    assert seeds.shape == (2 * game.n - 2, game.spec.nwords)
    np.testing.assert_array_equal(seeds.numpy(), np.stack(jgame._seeds))


@pytest.mark.parametrize("G", [1, 31, 32, 33, 127, 2048, 8192])
def test_direction_geometry(G):
    """reversi_play, reversi_is_over and line_is_over: four warps a block
    of 32 games (a warp a direction, a lane a game), the fewest blocks
    that cover G."""
    geo = R.direction_geometry(G)
    assert geo.threads == 128 == R.DIRECTION_WARPS * 32
    assert geo.blocks == -(-G // 32)
    assert (geo.blocks - 1) * R.DIRECTION_GAMES < G <= \
        geo.blocks * R.DIRECTION_GAMES


@pytest.mark.parametrize("n", range(2, 14))
def test_spread_geometry_covers_every_hex_size(n):
    """hex_is_over spreads hex<N>'s W words over L lanes of a warp a game:
    L the next power of two at or above W, so it divides 32 and no game
    crosses a warp; every lane below W holds a word."""
    W = R.hex_geometry(make_game(f"hex{n}").spec).words
    lanes = R.spread_geometry(W, 2048).lanes
    assert lanes >= W > lanes // 2
    assert lanes & (lanes - 1) == 0 and 32 % lanes == 0
    assert lanes == {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 7: 8}[W]


@pytest.mark.parametrize("G", [1, 127, 128, 1021, 2048, 8192])
@pytest.mark.parametrize("words", [1, 2, 3, 7])
def test_spread_geometry_covers_G(words, G):
    """Whole games a warp, the fewest blocks that cover G games, in
    blocks of 128 threads halved to a warp while the 132 SMs would not
    each get one."""
    geo = R.spread_geometry(words, G)
    assert geo.threads in (32, 64, 128) and geo.threads % geo.lanes == 0
    games = geo.threads // geo.lanes
    assert (geo.blocks - 1) * games < G <= geo.blocks * games
    assert geo.threads == 32 or geo.blocks >= R.NUM_SMS
    if geo.threads < 128:  # twice the threads would leave SMs idle
        assert -(-G * geo.lanes // (2 * geo.threads)) < R.NUM_SMS
    with pytest.raises(ValueError):
        R.spread_geometry(words, 0)


def test_spread_geometry_refuses_boards_past_hex13():
    """hex boards of 1-7 words."""
    for words in (0, 8):
        with pytest.raises(ValueError, match="hex_is_over"):
            R.spread_geometry(words, 64)


@pytest.mark.parametrize("name,G", [("reversi8x8", 1), ("reversi8x8", 127),
                                    ("reversi6x6", 1021), ("hex13", 1),
                                    ("hex13", 128), ("hex7", 1021),
                                    ("hex3", 127), ("tictactoe", 1),
                                    ("gobang13", 33)])
def test_wrappers_launch_the_spread_geometry(name, G, monkeypatch):
    """hex_is_over launches with ``spread_geometry`` for its G and words,
    reversi_play, reversi_is_over and line_is_over with
    ``direction_geometry`` for their G."""
    game = make_game(name)
    pos, action = R.sample_positions(game, G, seed=5)
    launched = []
    monkeypatch.setattr(R, "_on_cuda", lambda kernel, t: True)
    monkeypatch.setattr(R, "_launch",
                        lambda e, dev, *a: launched.append((e, a)))
    if name.startswith("reversi"):
        game.play(pos, action)
    game.is_over(pos)
    for entry, args in launched:
        if entry == "launch_hex_is_over":
            assert args[-3:] == tuple(R.spread_geometry(game.spec.nwords, G))
        else:
            assert entry in ("launch_reversi_play", "launch_reversi_is_over",
                             "launch_line_is_over")
            assert args[-2:] == tuple(R.direction_geometry(G))
    assert [e for e, _ in launched][-1] == "launch_" + game.is_over_kernel


@pytest.mark.parametrize("name,entry", [
    ("reversi8x8", "launch_reversi_play"),
    ("reversi6x6", "launch_reversi_is_over"),
    ("gobang13", "launch_line_is_over"),
    ("connect4", "launch_line_is_over"),
    ("hex13", "launch_hex_is_over"),
    ("hex7", "launch_hex_is_over")])
def test_wrappers_launch_their_kernel(name, entry, monkeypatch):
    """Where the boards are on the card (here: the dispatch told so), each
    wrapper launches its entry point with the geometry of its spec and new
    outputs, counts one launch, and raises when the launch fails - no
    plain fallback."""
    game = make_game(name)
    pos, action = R.sample_positions(game, 40, seed=3)
    launched = []
    monkeypatch.setattr(R, "_on_cuda", lambda kernel, t: True)
    monkeypatch.setattr(R, "_launch",
                        lambda e, dev, *a: launched.append((e, a)))
    K.reset_launch_counts()
    if entry == "launch_reversi_play":
        out = game.play(pos, action.to(torch.int32))
    else:
        out = game.is_over(pos)
    (got, args), = launched
    assert got == entry
    masks = next(a for a in args if isinstance(a, ctypes.Array))
    geo = (R.reversi_geometry(game.spec) if name.startswith("reversi")
           else R.hex_geometry(game.spec) if name.startswith("hex")
           else R.line_geometry(game.spec, game.nvict))
    assert list(masks) == list(geo.masks)
    ints = args[[id(a) for a in args].index(id(masks)) + 1:]
    # reversi_play, reversi_is_over and line_is_over: 128 threads a block,
    # 2 blocks of 32 games for 40
    if entry == "launch_reversi_play":
        assert ints == (40, 32, 8, 8, 2, 128, 2)  # G, action bits, geometry
    elif entry == "launch_reversi_is_over":
        assert ints == (40, 6, 6, 2, 128, 2)
    elif entry == "launch_hex_is_over":
        # 8 lanes a game for hex13's 7 words, 2 for hex7's 2
        lanes = 8 if name == "hex13" else 2
        assert ints == (40, geo.rows, geo.cols, geo.words, lanes, 32,
                        -(-40 * lanes // 32))
        assert (geo.rows, geo.words) == ((14, 7) if name == "hex13"
                                         else (8, 2))
    else:
        assert ints == (40, geo.rows, geo.cols, geo.words, geo.nvict, 128,
                        2)
    assert {n: c for n, (c, _) in K.launch_counts().items() if c} == {
        entry[len("launch_"):]: 1}
    for t in out:
        assert t.shape[0] == 40

    def fail(*a):
        raise RuntimeError(f"{entry}: CUDA error 1")

    monkeypatch.setattr(R, "_launch", fail)
    with pytest.raises(RuntimeError, match="CUDA error"):
        game.play(pos, action) if entry == "launch_reversi_play" \
            else game.is_over(pos)


def test_wrappers_check_their_tensors(monkeypatch):
    monkeypatch.setattr(R, "_on_cuda", lambda kernel, t: True)
    monkeypatch.setattr(R, "_launch", lambda e, dev, *a: None)
    game = make_game("reversi8x8")
    pos, action = R.sample_positions(game, 8, seed=4)
    with pytest.raises(ValueError, match="bopponent"):
        game.is_over(pos._replace(bopponent=pos.bopponent[:, :1]))
    with pytest.raises(ValueError, match="player"):
        game.is_over(pos._replace(player=pos.player.long()))
    with pytest.raises(ValueError, match="action"):
        game.play(pos, action.to(torch.int16))
    game = make_game("hex7")
    pos, _ = R.sample_positions(game, 8, seed=4)
    with pytest.raises(ValueError, match="bopponent"):
        game.is_over(pos._replace(bopponent=pos.bopponent[:, :1]))
    with pytest.raises(ValueError, match="player"):
        game.is_over(pos._replace(player=pos.player.long()))
    with pytest.raises(ValueError, match="hex_is_over: hex6"):
        R.hex_is_over(game.spec, 6, pos.bopponent, pos.player)


@pytest.mark.parametrize("name,owed", [
    ("reversi8x8", {"reversi_play": 10, "reversi_is_over": 10,
                    "line_is_over": 0, "hex_is_over": 0}),
    ("gobang13", {"reversi_play": 0, "reversi_is_over": 0,
                  "line_is_over": 10, "hex_is_over": 0}),
    ("connect4", {"reversi_play": 0, "reversi_is_over": 0,
                  "line_is_over": 10, "hex_is_over": 0}),
    ("hex7", {"reversi_play": 0, "reversi_is_over": 0, "line_is_over": 0,
              "hex_is_over": 10})])
def test_rules_owed(name, owed):
    """10 calls of play and 10 of is_over owe the game's wrappers; the
    line games and hex play with torch ops and owe their end test's
    kernel alone."""
    assert R.rules_owed(make_game(name), 10) == owed


@pytest.mark.parametrize("name,G", [("reversi8x8", 8192),
                                    ("gobang13", 2048), ("hex7", 8192),
                                    ("hex13", 2048)])
def test_rules_cost(name, G):
    """Each input byte read once and each output byte written once; the
    bound is the bytes' time at these sizes, but for hex13's flood."""
    game = make_game(name)
    W = game.spec.nwords
    if name.startswith("reversi"):
        play = bounds.rules_cost("reversi_play", game.spec, G, 8)
        assert play.nbytes == G * (2 * W * 8 + 8 + 1) + G * (3 * W * 8 + 1)
        over = bounds.rules_cost("reversi_is_over", game.spec, G)
        assert over.nbytes == G * (3 * W * 8 + 1) + G * 2
        assert play.bound_by == over.bound_by == "bytes"
    elif name.startswith("hex"):
        # the previous mover's board and player read, done and result
        # written; 2N-2 steps of about ten word operations a word
        over = bounds.rules_cost("hex_is_over", game.spec, G)
        assert over.nbytes == G * (W * 8 + 1) + G * 2
        assert over.ops == G * (2 * game.n - 2) * W * 10
        # hex13's 24 steps over seven words outweigh its 59 bytes a game
        assert over.bound_by == ("operations" if name == "hex13"
                                 else "bytes")
    else:
        over = bounds.rules_cost("line_is_over", game.spec, G, nvict=5)
        assert over.nbytes == G * (2 * W * 8 + 1) + G * 2
        assert over.bound_by == "bytes"
    with pytest.raises(ValueError):
        bounds.rules_cost("select", game.spec, G)

