"""Properties of the port as a package, and its kernels on the card.

The CPU tests check that ``alphatpu_torch`` never imports JAX and builds
nothing at import.  The tests marked ``cuda`` hold each CUDA kernel to its
plain torch version on the card, and the rounds replayed from CUDA graphs
to eager rounds (bit for bit, launches as owed); they skip where torch
finds no CUDA device.
"""
import ctypes
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
MODULES = (
    "alphatpu_torch", "alphatpu_torch.bitboard", "alphatpu_torch.games",
    "alphatpu_torch.games.connect4", "alphatpu_torch.games.gobang",
    "alphatpu_torch.games.hex", "alphatpu_torch.games.reversi",
    "alphatpu_torch.games.kernels",
    "alphatpu_torch.nets", "alphatpu_torch.mcts.tree",
    "alphatpu_torch.mcts.newton", "alphatpu_torch.mcts.kernels",
    "alphatpu_torch.mcts.bounds", "alphatpu_torch.mcts.deep_trees",
    "alphatpu_torch.mcts.search", "alphatpu_torch.buffer",
    "alphatpu_torch.selfplay", "alphatpu_torch.train", "alphatpu_torch.duel",
    "alphatpu_torch.checkpoint", "alphatpu_torch.pipeline",
    "alphatpu_torch.cli", "alphatpu_torch._build", "alphatpu_torch.probe",
    "alphatpu_torch.eval", "alphatpu_torch.oracles",
    "alphatpu_torch.cpu_mcts", "alphatpu_torch.render",
    "alphatpu_torch.interactive", "alphatpu_torch.nets.zoo",
    "alphatpu_torch.parallel", "alphatpu_torch.parallel.mesh",
    "alphatpu_torch.parallel.sharded", "alphatpu_torch.parallel.dryrun",
    "alphatpu_torch.bench", "alphatpu_torch.graphs",
    "alphatpu_torch.benchmarks",
    "alphatpu_torch.benchmarks.matrix",
    "alphatpu_torch.benchmarks.ablate_rollout",
    "alphatpu_torch.benchmarks.ttt_loss_replay",
    "alphatpu_torch.benchmarks.captured_rounds",
    "alphatpu_torch.benchmarks.train_record",
    "alphatpu_torch.benchmarks.gate_record",
    "alphatpu_torch.benchmarks.probe_moves",
    "alphatpu_torch.benchmarks.probe_pair",
)

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)


def test_port_never_imports_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {MODULES!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "alphatpu.")))
        assert not bad, bad
        from alphatpu_torch import _build
        assert _build.load_library.cache_info().currsize == 0  # nothing built
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("argv", [[], ["--rules"]])
def test_smoke_refuses_without_a_card(argv):
    """chip_smoke.py - the whole smoke, and ``--rules``, its phases 1-2 and
    rules parity alone (how the rules kernels of another tree of the port
    are timed beside this one's, the script copied to that tree) - exits
    non-zero and prints no result where torch finds no card."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py", *argv], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_build_paths_are_inside_the_package():
    from alphatpu_torch import _build

    assert _build.BUILD_DIR.parent == _build.PACKAGE_DIR
    names = {p.name for p in _build.sources()}
    assert names == {"select_apply_packed.cu", "select_apply_packed1.cu",
                     "select_apply.cu", "select.cu", "backup.cu",
                     "rules.cu"}
    assert {p.name for p in _build.hashed_sources()} == names | {"walk.cuh"}
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    for flag in ("arch=compute_90a,code=sm_90a", "-fmad=false"):
        assert flag in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    # .gitignore keeps built libraries out of the repository
    assert "alphatpu_torch/_build/" in (REPO / ".gitignore").read_text()


_C_ENTRY = re.compile(r'extern "C" int (launch_\w+)\((.*?)\)\s*\{', re.S)


def _c_entry_points() -> dict:
    """Every ``extern "C" int launch_*`` of ``csrc/*.cu``: name -> its
    parameters as ctypes types (a pointer, an int or a float)."""
    from alphatpu_torch import _build

    def ctype(param):
        decl = " ".join(param.split())
        if "*" in decl:
            return ctypes.c_void_p
        kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
        assert decl.split()[0] in kinds, decl
        return kinds[decl.split()[0]]

    return {name: [ctype(p) for p in params.split(",")]
            for src in _build.sources()
            for name, params in _C_ENTRY.findall(src.read_text())}


def test_signatures_name_every_c_entry_point():
    from alphatpu_torch import _build

    assert set(_c_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("entry", [
    "launch_select_apply_packed", "launch_select_apply_packed1",
    "launch_select_apply", "launch_select", "launch_backup",
    "launch_select_apply_bf16", "launch_select_bf16", "launch_backup_bf16",
    "launch_reversi_play", "launch_reversi_is_over", "launch_line_is_over",
    "launch_hex_is_over"])
def test_signatures_match_the_c_declarations(entry):
    """ctypes passes what ``_SIGNATURES`` declares: a mismatch with the C
    parameters would show only on the card, as a wrong argument."""
    from alphatpu_torch import _build

    assert _build._SIGNATURES[entry] == _c_entry_points()[entry]


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """An edit to a header the kernels include changes the library's name,
    so the next use rebuilds it."""
    from alphatpu_torch import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.hashed_sources():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    before = _build.library_path()
    assert before.parent == tmp_path / "_build"
    assert _build.library_path() == before  # a pure function of the bytes
    header = csrc / "walk.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = _build.library_path()
    assert after != before and after.parent == before.parent
    assert [p.name for p in _build.sources()] == sorted(
        p.name for p in csrc.glob("*.cu"))  # headers are not compiled


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no "
                    "CPU mode, their plain versions are tested on the CPU")
    return torch.device("cuda")


def _grown(device, G, V, seed):
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game

    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game, width=64, depth=2), seed,
                        device=device)
    tree = init_tree(game, game.initial(G, device), V)
    run_mcts(game, net, tree, rollouts=V - 2, cpuct=1.5, training=True,
             generator=torch.Generator(device=device).manual_seed(seed))
    return game, tree


RULES_GAMES = ("reversi6x6", "reversi8x8", "tictactoe", "connect4", "gobang8",
               "gobang9", "gobang13", "hex4", "hex7", "hex13")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 33, 127, 1021])
@pytest.mark.parametrize("name", RULES_GAMES)
def test_rules_kernels_match_plain(name, G, cuda):
    """The rules kernels equal their plain versions bit for bit on sampled
    positions - dead lanes given any action, reversi's pass, full boards
    - at lane counts that leave the last warp or block part full (one
    game; 33, 127 and 1021 games: a lane a word, or the tail of a block of
    32 games a warp a direction); reversi's end test also with the movers
    without a move gathered first (blocks that skip the opponent's chain
    beside blocks that run it); each call launches one kernel."""
    from alphatpu_torch.games import kernels as R
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts import kernels as K

    game = make_game(name)
    pos, action = R.sample_positions(game, G, seed=7, device=cuda)
    reversi = name.startswith("reversi")
    K.reset_launch_counts()
    got = [game.is_over(pos)]
    if reversi:
        got += [game.play(pos, action), game.play(pos, action.int())]
    got.append(game.is_over(game.play(pos, action)))
    if reversi:
        got.append(game.is_over(R.stuck_first(pos)))
    torch.cuda.synchronize()
    played = game.play(pos, action) if not reversi else type(pos)(
        *R.reversi_play_plain(game.spec, pos.bplayer, pos.bopponent,
                              pos.player, action))
    if reversi:
        over = [R.reversi_is_over_plain(game.spec, *p[:4]) for p in
                (pos, played, R.stuck_first(pos))]
        want = [over[0], played, played, over[1], over[2]]
    elif name.startswith("hex"):
        want = [R.hex_is_over_plain(game.spec, game.n, p.bopponent, p.player)
                for p in (pos, played)]
    else:
        want = [R.line_is_over_plain(game.spec, game.nvict, p.bplayer,
                                     p.bopponent, p.player)
                for p in (pos, played)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    counts = {k: n for k, (n, _) in K.launch_counts().items() if n}
    assert counts == ({"reversi_play": 3, "reversi_is_over": 3} if reversi
                      else {game.is_over_kernel: 2})


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(2, 14))
def test_hex_kernel_matches_plain_at_every_size(n, cuda):
    """hex_is_over on hex<N> for every N from 2 to 13 - one to seven words
    over 1, 2, 4 or 8 lanes a game, among them the sizes whose words fill
    their lanes (hex5-hex7, hex9-hex10), where no spare lane supplies the
    zero past the last word - equals hex_is_over_plain bit for bit, before
    and after each lane's move, in one launch a call."""
    from alphatpu_torch.games import kernels as R
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts import kernels as K

    game = make_game(f"hex{n}")
    pos, action = R.sample_positions(game, 509, seed=n, device=cuda)
    played = game.play(pos, action)
    K.reset_launch_counts()
    got = [game.is_over(p) for p in (pos, played)]
    torch.cuda.synchronize()
    assert K.launch_counts()["hex_is_over"] == (2, 0)
    for g, p in zip(got, (pos, played)):
        want = R.hex_is_over_plain(game.spec, n, p.bopponent, p.player)
        for a, b in zip(g, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_select_apply_packed_kernel_matches_plain(cuda):
    from alphatpu_torch.mcts import kernels as K

    game, tree = _grown(cuda, 1024, 32, 0)
    D = min(game.max_game_length, 32)
    S = K.value_scale(32)
    packed = K.pack_stats(tree.wsum, tree.visits, S)
    probs = torch.rand((D, 1024), device=cuda)
    pend = K.empty_pending(D, game.max_actions, 1024, cuda)
    a = (tree.prior.clone(), packed.clone())
    b = (tree.prior.clone(), packed.clone())
    before = K.select_apply_packed.launches
    sk = K.select_apply_packed(*a, tree.parent, tree.action_from,
                               tree.expanded, probs, pend, 1.5, S)
    sp = K.select_apply_packed_plain(*b, tree.parent, tree.action_from,
                                     tree.expanded, probs, pend, 1.5, S)
    torch.cuda.synchronize()
    assert K.select_apply_packed.launches == before + 1
    for x, y in zip(a + tuple(sk), b + tuple(sp)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_backup_kernel_matches_plain(cuda):
    from alphatpu_torch.mcts import kernels as K

    game, tree = _grown(cuda, 1024, 32, 1)
    D = min(game.max_game_length, 32)
    sel = K.select_apply_packed_plain(
        tree.prior.clone(), K.pack_stats(tree.wsum, tree.visits, 1024),
        tree.parent, tree.action_from, tree.expanded,
        torch.rand((D, 1024), device=cuda),
        K.empty_pending(D, game.max_actions, 1024, cuda), 1.5, 1024)
    length = (sel.nodes >= 0).sum(0, dtype=torch.int32)
    value = torch.rand((1024,), device=cuda)
    a = (tree.wsum.clone(), tree.visits.clone())
    b = (tree.wsum.clone(), tree.visits.clone())
    K.backup(*a, sel.nodes, sel.actions, length, value)
    K.backup_plain(*b, sel.nodes, sel.actions, length, value)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], rtol=1e-6, atol=0.0)


def _pending(sel, next_idx, A, scale=None):
    """A real pending update from a walk: random value (on the 1/scale grid
    when given), random normalized prior row, leaf == V on a few lanes."""
    from alphatpu_torch.mcts import kernels as K

    G = sel.leaf.shape[0]
    dev = sel.leaf.device
    newp = torch.rand((A, G), device=dev)
    value = torch.rand((G,), device=dev)
    leaf = torch.where(sel.needs_alloc, next_idx, sel.leaf)
    leaf[:8] = 10_000
    return K.PendingUpdate(
        sel.nodes, sel.actions, (sel.nodes >= 0).sum(0, dtype=torch.int32),
        value if scale is None else K.quantize_value(value, scale), leaf,
        newp / newp.sum(0, keepdim=True), torch.rand((G,), device=dev) < 0.9)


@pytest.mark.cuda
def test_select_apply_packed1_kernel_matches_plain(cuda):
    from alphatpu_torch.mcts import kernels as K

    game, tree = _grown(cuda, 1024, 32, 2)
    D = min(game.max_game_length, 32)
    layout = K.packed1_layout(32)
    packed = K.pack1_stats(tree.prior, tree.wsum, tree.visits, layout)
    walk = (tree.parent, tree.action_from, tree.expanded)
    first = K.select_apply_packed1_plain(
        packed.clone(), *walk, torch.rand((D, 1024), device=cuda),
        K.empty_pending(D, game.max_actions, 1024, cuda), 1.5, layout)
    pend = _pending(first, tree.next_idx, game.max_actions, layout.scale)
    probs = torch.rand((D, 1024), device=cuda)
    a, b = packed.clone(), packed.clone()
    before = K.select_apply_packed1.launches
    sk = K.select_apply_packed1(a, *walk, probs, pend, 1.5, layout)
    sp = K.select_apply_packed1_plain(b, *walk, probs, pend, 1.5, layout)
    torch.cuda.synchronize()
    assert K.select_apply_packed1.launches == before + 1
    for x, y in zip((a,) + tuple(sk), (b,) + tuple(sp)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_select_apply_and_select_kernels_match_plain(cuda):
    """The f32 engine's kernel against its plain version with a real
    pending update, and the read-only select kernel against select_apply's
    walk with an empty one, bit for bit."""
    from alphatpu_torch.mcts import kernels as K

    game, tree = _grown(cuda, 1024, 32, 3)
    A = game.max_actions
    D = min(game.max_game_length, 32)
    walk = (tree.parent, tree.action_from, tree.expanded)
    planes = (tree.prior, tree.wsum, tree.visits)
    probs = torch.rand((D, 1024), device=cuda)
    before = (K.select_apply.launches, K.select.launches)
    copy = [p.clone() for p in planes]
    s4 = K.select_apply(*copy, *walk, probs, K.empty_pending(D, A, 1024, cuda),
                        1.5)
    s5 = K.select(*planes, *walk, probs, 1.5)
    sp = K.select_plain(*planes, *walk, probs, 1.5)
    torch.cuda.synchronize()
    for x, y, z in zip(s4, s5, sp):
        assert torch.equal(x, y) and torch.equal(y, z)
    pend = _pending(s5, tree.next_idx, A)
    a = [p.clone() for p in planes]
    b = [p.clone() for p in planes]
    sk = K.select_apply(*a, *walk, probs, pend, 1.5)
    sq = K.select_apply_plain(*b, *walk, probs, pend, 1.5)
    torch.cuda.synchronize()
    assert (K.select_apply.launches, K.select.launches) == (before[0] + 2,
                                                            before[1] + 1)
    for x, y in zip(tuple(a) + tuple(sk), tuple(b) + tuple(sq)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 200, 1024])
def test_bf16_kernels_match_plain(G, cuda):
    """The bf16 instantiations of select_apply, select and backup on a
    connect4 tree grown on bf16 planes (the level-0 engine, itself on
    them), each against its plain version bit for bit; their launches are
    counted under the kernels' names and as bf16."""
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game

    game = make_game("connect4")
    A, V = game.max_actions, 32
    D = min(game.max_game_length, V)
    net = MLP.from_seed(config_for_game(game, width=64, depth=2), 5,
                        device=cuda)
    tree = init_tree(game, game.initial(G, cuda), V,
                     stat_dtype=torch.bfloat16)
    K.reset_launch_counts()
    run_mcts(game, net, tree, rollouts=V - 2, cpuct=1.5, training=True,
             generator=torch.Generator(device=cuda).manual_seed(5))
    assert (K.select_apply.launches, K.select_apply.launches_bf16,
            K.backup.launches, K.backup.launches_bf16) == (V - 2, V - 2, 1, 1)
    walk = (tree.parent, tree.action_from, tree.expanded)
    planes = (tree.prior, tree.wsum, tree.visits)
    assert {p.dtype for p in planes} == {torch.bfloat16}
    probs = torch.rand((D, G), device=cuda)
    s5 = K.select(*planes, *walk, probs, 1.5)
    sp = K.select_plain(*planes, *walk, probs, 1.5)
    pend = _pending(s5, tree.next_idx, A)
    a = [p.clone() for p in planes]
    b = [p.clone() for p in planes]
    sk = K.select_apply(*a, *walk, probs, pend, 1.5)
    sq = K.select_apply_plain(*b, *walk, probs, pend, 1.5)
    bk = [p.clone() for p in planes[1:]]
    bp = [p.clone() for p in planes[1:]]
    K.backup(*bk, s5.nodes, s5.actions, pend.length, pend.value)
    K.backup_plain(*bp, s5.nodes, s5.actions, pend.length, pend.value)
    torch.cuda.synchronize()
    assert K.select.launches == K.select.launches_bf16 == 1
    for x, y in zip(s5, sp):
        assert torch.equal(x, y)
    for x, y in zip(tuple(a) + tuple(sk) + tuple(bk),
                    tuple(b) + tuple(sq) + tuple(bp)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert not torch.equal(a[1], tree.wsum)  # the apply phase wrote


def _synthetic_tree(A, V, G, scale, device, seed):
    """A random tree of V - 2 allocated nodes per game (numpy, from a
    seed): each node's children under distinct actions, normalized priors
    over random legal moves, most of a node's mass and small integer
    visits on its child edges (so walks go deep), value sums on the
    1/scale grid; some leaves expanded, so walks also ask for new nodes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = V - 2
    gi = np.arange(G)
    parent = np.full((V, G), -1, np.int32)
    action_from = np.zeros((V, G), np.int32)
    children = np.zeros((V, G), np.int64)
    offset = rng.integers(0, A, (V, G))
    for v in range(1, n):
        up = rng.integers(0, v, G)
        up = np.where(children[up, gi] >= A, v - 1, up)  # v - 1: no child
        parent[v] = up
        action_from[v] = (offset[up, gi] + children[up, gi]) % A
        children[up, gi] += 1
    expanded = np.zeros((V, G), bool)
    expanded[:n] = (children[:n] > 0) | (rng.random((n, G)) < 0.5)
    expanded[0] = True
    child = np.zeros((A, V, G), bool)
    for v in range(1, n):
        child[action_from[v], parent[v], gi] = True
    legal = (rng.random((A, V, G)) < 0.7) | child
    legal &= expanded[None]
    prior = np.where(legal, rng.random((A, V, G)), 0.0)
    prior = np.where(child, prior + 20.0, prior)
    prior /= np.maximum(prior.sum(0, keepdims=True), 1e-30)
    visits = np.where(child, rng.integers(1, 5, (A, V, G)), 0)
    wsum = np.floor(rng.random((A, V, G)) * visits * scale) / scale
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (t(prior.astype(np.float32)), t(wsum.astype(np.float32)),
            t(visits.astype(np.float32)), t(parent), t(action_from),
            t(expanded), t(np.full((G,), n, np.int32)))


def _walks_match_plain(kernel, A, V, G, D, seed, device):
    """Two calls of the group-walk kernel ``kernel`` against its plain
    version, bit for bit, on a synthetic tree: the second applies the first
    walk's update (select_apply kernels; no prior row written on a few
    lanes), and ``select`` is also held to ``select_apply``'s walk with an
    empty pending update.  The packed kernels take the tree's stats packed
    (level 2: the 1-plane word of a V-rollout search).  Returns the tree's
    f32 planes and the last walk with its pending update."""
    from alphatpu_torch.mcts import kernels as K

    S = K.value_scale(V)
    layout = K.packed1_layout(V)
    prior, wsum, visits, *walk, next_idx = _synthetic_tree(
        A, V, G, S, device, seed)
    launches = {k: getattr(K, k).launches for k in (
        "select_apply_packed", "select_apply_packed1", "select_apply",
        "select")}
    pend = K.empty_pending(D, A, G, device)
    for step in range(2):
        probs = torch.rand((D, G), device=device)
        if kernel == "select_apply_packed":
            a = (prior.clone(), K.pack_stats(wsum, visits, S))
            b = tuple(t.clone() for t in a)
            sk = K.select_apply_packed(*a, *walk, probs, pend, 1.5, S)
            sp = K.select_apply_packed_plain(*b, *walk, probs, pend, 1.5, S)
        elif kernel == "select_apply_packed1":
            a = (K.pack1_stats(prior, wsum, visits, layout),)
            b = (a[0].clone(),)
            sk = K.select_apply_packed1(*a, *walk, probs, pend, 1.5, layout)
            sp = K.select_apply_packed1_plain(*b, *walk, probs, pend, 1.5,
                                              layout)
        elif kernel == "select_apply":
            a = (prior.clone(), wsum.clone(), visits.clone())
            b = tuple(t.clone() for t in a)
            sk = K.select_apply(*a, *walk, probs, pend, 1.5)
            sp = K.select_apply_plain(*b, *walk, probs, pend, 1.5)
        else:
            a = b = (prior, wsum, visits)
            sk = K.select(*a, *walk, probs, 1.5)
            sp = K.select_plain(*b, *walk, probs, 1.5)
            s4 = K.select_apply(prior.clone(), wsum.clone(), visits.clone(),
                                *walk, probs, pend, 1.5)
            assert all(torch.equal(x, y) for x, y in zip(sk, s4))
        torch.cuda.synchronize()
        for x, y in zip(a + tuple(sk), b + tuple(sp)):
            assert torch.equal(x, y)
        if kernel != "select":  # the f32 engine backs up unquantized
            grid = {"select_apply_packed": S,
                    "select_apply_packed1": layout.scale}
            pend = _pending(sk, next_idx, A, grid.get(kernel))
    if G > 1:  # walks went below the root, and some asked for a node
        assert (sk.nodes >= 0).sum() > G and sk.needs_alloc.any()
    launches[kernel] += 2
    if kernel == "select":
        launches["select_apply"] += 2
    assert {k: getattr(K, k).launches for k in launches} == launches
    return wsum, visits, sk, pend


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 200, 8192])
@pytest.mark.parametrize("A", [1, 7, 9, 33, 169])
@pytest.mark.parametrize("kernel", [
    "select_apply_packed", "select_apply_packed1", "select_apply", "select"])
def test_main_path_kernels_match_plain_at_every_geometry(kernel, A, G, cuda):
    """The four group walks against their plain versions, bit for bit, at
    group widths from 1 to 32 lanes (A=1: 32 games per warp; A=9: 16 lanes
    for 9 actions; A=33 and 169: 32 lanes of 2 and 6 slots), on one game,
    a partial block and warp (G=200), and 8192 games; with
    select_apply_packed, backup against its plain version on its path."""
    from alphatpu_torch.mcts import kernels as K

    V = 16
    wsum, visits, sk, pend = _walks_match_plain(kernel, A, V, G, V,
                                                A * 7 + G, cuda)
    if kernel != "select_apply_packed":
        return
    before = K.backup.launches
    value = torch.rand((G,), device=cuda)
    path = (sk.nodes, sk.actions, pend.length, value)
    a = (wsum.clone(), visits.clone())
    b = (wsum.clone(), visits.clone())
    K.backup(*a, *path)
    K.backup_plain(*b, *path)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert K.backup.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [
    "select_apply_packed", "select_apply_packed1", "select_apply", "select"])
def test_f32_walks_read_columns_from_device_memory(kernel, cuda):
    """A tree whose columns do not fit a block's shared memory (A=7,
    V=8000: 4 games x 64 KB): every walk kernel takes the device placement
    and stays bit for bit equal to its plain version, over D=200 recorded
    depths (not a multiple of the group's 8 lanes)."""
    from alphatpu_torch.mcts import kernels as K

    A, V, G = 7, 8000, 512
    assert K.walk_geometry(A, G, V).placement == K.DEVICE_COLUMNS
    _walks_match_plain(kernel, A, V, G, 200, 5, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2])
def test_packed_levels_search_a_tree_in_device_memory(level, cuda):
    """A 64-rollout search at level 1 or 2 on connect4 trees of 7,300
    nodes, whose columns exceed a block's shared memory (the device
    placement), on the card against the CPU path from the same uniforms.
    Both nets hold the same weights in {-1/8, 0, 1/8}, so their products
    are exact on either device; a rounding of exp or sigmoid that moves a
    prior or a leaf value across its grid may still change a lane: at most
    2 of 256 differ.  The others hold the same tree, visits and wsum."""
    import numpy as np

    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import config_for_game, params_from_jax
    from alphatpu_torch.nets.mlp import init_numpy

    game = make_game("connect4")
    A, V, G, R = game.max_actions, 7300, 256, 64
    assert K.walk_geometry(A, G, V).placement == K.DEVICE_COLUMNS
    cfg = config_for_game(game, width=32, depth=2)
    rng = np.random.default_rng(6)
    flat = {k: np.zeros_like(v) if k.endswith("_b")
            else (rng.integers(-1, 2, v.shape) / 8).astype(np.float32)
            for k, v in init_numpy(cfg, 0).items()}
    probs = torch.from_numpy(np.random.default_rng(7).random(
        (R, game.max_game_length, G), dtype=np.float32))
    kernel = K.select_apply_packed if level == 1 else K.select_apply_packed1
    trees = []
    for dev in (cuda, torch.device("cpu")):
        tree = init_tree(game, game.initial(G, dev), V)
        before = kernel.launches
        run_mcts(game, params_from_jax(flat, cfg, device=dev), tree,
                 rollouts=R, cpuct=1.5, training=True, probs=probs.to(dev),
                 packed_stats=level)
        trees.append(tree)
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernel.launches == before + R
    fields = ("parent", "action_from", "expanded", "next_idx", "visits",
              "wsum")
    bad = torch.zeros(G, dtype=torch.bool)
    for f in fields:
        x, y = (getattr(t, f).cpu() for t in trees)
        bad |= (x != y).reshape(-1, G).any(0)
    assert int(bad.sum()) <= 2, int(bad.sum())
    assert bool((trees[1].visits[:, 0].sum(0) == R - 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("env,kernel", [
    ({}, "select_apply_packed"),
    ({"ALPHATPU_PACK": "2"}, "select_apply_packed1"),
    ({"ALPHATPU_NO_PACK": "1"}, "select_apply"),
])
def test_switches_launch_engines(env, kernel, cuda, monkeypatch):
    from alphatpu_torch.mcts import kernels as K

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    K.reset_launch_counts()
    _grown(cuda, 256, 16, 4)
    assert {k.__name__: k.launches for k in K.KERNELS} == {
        "select_apply_packed": 0, "select_apply_packed1": 0,
        "select_apply": 0, "select": 0, "backup": 1, kernel: 14,
        "reversi_play": 0, "reversi_is_over": 0, "line_is_over": 14,
        "hex_is_over": 0}


@pytest.mark.cuda
def test_one_generation_on_the_card(cuda, tmp_path):
    """A tictactoe generation on the card goes through the two main-path
    kernels and reloads bit for bit."""
    from alphatpu_torch.duel import DuelConfig
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.nets import PARAM_NAMES
    from alphatpu_torch.pipeline import (
        PipelineConfig, init_pipeline, resume, run_generation,
    )
    from alphatpu_torch.selfplay import SelfplayConfig
    from alphatpu_torch.train import TrainConfig

    game = make_game("tictactoe")
    cfg = PipelineConfig(
        selfplay=SelfplayConfig(num_games=256, rollouts=16),
        train=TrainConfig(batch_size=32), duel=DuelConfig(num_games=64,
                                                          rollouts=8),
        buffer_capacity=4096, generations=1, width=32, depth=2,
        ckpt_dir=str(tmp_path), device="cuda", log=lambda s: None)
    state = init_pipeline(game, cfg)
    K.reset_launch_counts()
    state, stats = run_generation(game, state, cfg)
    T = game.max_game_length
    assert K.select_apply_packed.launches == T * 16 + 2 * T * 8
    assert K.backup.launches == T + 2 * T
    assert stats["illegal_moves"] == 0
    assert (stats["wins"] + stats["draws"] + stats["losses"]
            + stats["unfinished"]) == 256
    assert math.isfinite(stats["loss"])
    fresh = init_pipeline(game, cfg)
    resume(game, fresh, cfg)
    for name in PARAM_NAMES:
        assert torch.equal(getattr(fresh.train_net, name),
                           getattr(state.train_net, name))
    assert torch.equal(fresh.rng.get_state(), state.rng.get_state())


@pytest.mark.cuda
def test_evaluation_and_play_on_the_card(cuda):
    """eval_vs_probe, eval_vs_random and the interactive engine (one game)
    search on the card through the two main-path kernels, with the launches
    each owes: R and 1 per searched ply or move."""
    from alphatpu_torch.eval import EvalConfig, eval_vs_random
    from alphatpu_torch.games import make_game
    from alphatpu_torch.interactive import make_engine
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.nets import MLP, config_for_game
    from alphatpu_torch.probe import eval_vs_probe

    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game, width=32, depth=2), 0,
                        device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    K.reset_launch_counts()
    w, d, l, trace = eval_vs_probe(game, net, gen, num_games=16, rollouts=8,
                                   trace=True, device=cuda)
    plies = len(trace["records"])
    assert w + d + l == 16 and 5 <= plies <= 9
    assert (K.select_apply_packed.launches, K.backup.launches) == (
        plies * 8, plies)

    K.reset_launch_counts()
    assert sum(eval_vs_random(game, net, gen, EvalConfig(num_games=8,
                                                         rollouts=8),
                              device=cuda)) == 8
    assert (K.select_apply_packed.launches, K.backup.launches) == (
        2 * 9 * 8, 2 * 9)

    K.reset_launch_counts()
    choose = make_engine(game, net, 16, 1.5)
    pos = game.initial(1, cuda)
    for _ in range(3):
        action, pi = choose(pos, gen)
        assert bool(game.legal_mask(pos)[0, action])
        pos = game.play(pos, torch.tensor([action], device=cuda))
    assert (K.select_apply_packed.launches, K.backup.launches) == (3 * 16, 3)


@pytest.mark.cuda
def test_bench_on_the_card(cuda):
    """``bench.measure`` on the card: the launches each timed generation
    owes (measure raises otherwise), no illegal move, the device's own
    numbers."""
    from alphatpu_torch import bench
    from alphatpu_torch.games import make_game

    r = bench.measure("tictactoe", games=1024, rounds=4, device="cuda")
    ex = r["extra"]
    assert ex["launches"] == ex["launches_owed"] == bench.owed_launches(
        make_game("tictactoe"), 1, 64, 4, 1)
    assert ex["illegal_moves"] == 0
    assert ex["env_steps"] == 1024 * 4
    assert ex["device"]["type"] == "cuda" and ex["device"]["count"] >= 1
    assert ex["peak_mem_bytes"] > 0 and ex["nn_mfu"] > 0
    assert r["metric"] == "torch_selfplay_env_steps_per_s_tictactoe_g1024_r64"


# ---------------------------------------------------------------------------
# captured rounds (alphatpu_torch.graphs) against eager rounds
# ---------------------------------------------------------------------------

_SMALL = dict(num_games=64, rollouts=16)  # tictactoe, 64 lanes, 16 rollouts


def _tiny_net(device, seed=0):
    from alphatpu_torch.games import make_game
    from alphatpu_torch.nets import MLP, config_for_game

    game = make_game("tictactoe")
    return game, MLP.from_seed(config_for_game(game, width=32, depth=2), seed,
                               device=device)


def _uniforms(game, T, R, G, device, seed):
    from alphatpu_torch.selfplay import SelfplayUniforms

    g = torch.Generator(device=device).manual_seed(seed)
    D = min(game.max_game_length, R)
    return SelfplayUniforms(
        torch.rand((T, R, D, G), generator=g, device=device),
        torch.rand((T, G), generator=g, device=device))


def _selfplay_calls(mode, game, nets, device, captured, injected, calls=2):
    """``calls`` chained selfplay calls of ``mode`` on the card, the i-th
    with ``nets[i]``; returns every tensor they leave (buffer, stats,
    carry, generator state) and the launch counts."""
    from alphatpu_torch.buffer import create_buffer
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.selfplay import (
        SelfplayConfig, make_carry, selfplay_continuous, selfplay_generation,
    )

    T = 6 if mode == "continuous" else game.max_game_length
    cfg = SelfplayConfig(**_SMALL, temp_moves=3, rounds=T)
    buf = create_buffer(game, 4096, device=device)
    gen = torch.Generator(device=device).manual_seed(11)
    carry = make_carry(game, cfg.num_games, gen, device)
    out = []
    K.reset_launch_counts()
    for i, net in enumerate(nets):
        u = (_uniforms(game, T, cfg.rollouts, cfg.num_games, device, i)
             if injected else None)
        if mode == "continuous":
            _, stats, carry = selfplay_continuous(
                game, net, buf, None, cfg, carry, uniforms=u,
                captured=captured)
            out += [carry.count, carry.enc, carry.pol, carry.player,
                    *carry.positions]
        else:
            _, stats = selfplay_generation(game, net, buf, gen, cfg,
                                           uniforms=u, captured=captured)
        out += [stats[k] for k in sorted(stats)]
    out += [getattr(buf, f) for f in ("state", "policy", "player", "value",
                                      "fstate", "cursor", "total")]
    out.append(gen.get_state())
    return out, K.launch_counts()


def _equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), i


@pytest.mark.cuda
@pytest.mark.parametrize("mode,injected", [
    ("continuous", False), ("continuous", True), ("generation", False)])
def test_captured_selfplay_equals_eager(mode, injected, cuda):
    """Two chained calls: the first captures the round (its round 0 runs
    eagerly) and the tail (after its eager run), the second replays every
    round and the tail; buffer, stats, carry and the generator's state
    equal the eager rounds' bit for bit, and the launch counts too."""
    from alphatpu_torch import graphs

    game, net = _tiny_net(cuda)
    graphs.clear_cache()
    graphs.reset_counts()
    captured, launches = _selfplay_calls(mode, game, (net, net), cuda, True,
                                         injected)
    T = 6 if mode == "continuous" else game.max_game_length
    # the first call: round 0 eager, then captured; the tail eager, then
    # captured; the second call replays T rounds and the tail
    assert graphs.counts["captures"] == 2
    assert graphs.counts["replays"] == 2 * T
    eager, eager_launches = _selfplay_calls(mode, game, (net, net), cuda,
                                            False, injected)
    _equal(captured, eager)
    assert launches == eager_launches
    assert launches["select_apply_packed"] == (2 * T * 16, 0)
    assert launches["backup"] == (2 * T, 0)


@pytest.mark.cuda
def test_captured_duel_half_equals_eager(cuda):
    """Both halves of a duel (one program, a graph per net): the tally and
    the generator's state bit for bit, launches as owed."""
    from alphatpu_torch import graphs
    from alphatpu_torch.duel import DuelConfig, duel_half
    from alphatpu_torch.mcts import kernels as K

    game, a = _tiny_net(cuda, 0)
    _, b = _tiny_net(cuda, 1)
    cfg = DuelConfig(**_SMALL, temp_moves=3)
    T = game.max_game_length
    results = []
    for captured in (True, False):
        graphs.clear_cache()
        graphs.reset_counts()
        K.reset_launch_counts()
        gen = torch.Generator(device=cuda).manual_seed(5)
        tally = [*duel_half(game, a, b, gen, cfg, cuda, captured=captured),
                 *duel_half(game, b, a, gen, cfg, cuda, captured=captured)]
        results.append((tally + [gen.get_state()], K.launch_counts(),
                        dict(graphs.counts)))
    (cap, cap_launches, counts), (eager, eager_launches, _) = results
    _equal(cap, eager)
    assert cap_launches == eager_launches
    assert cap_launches["select_apply_packed"] == (2 * T * 16, 0)
    assert counts["captures"] == 2 and counts["replays"] == 2 * T - 2
    assert sum(int(x) for x in cap[:4]) == cfg.num_games


@pytest.mark.cuda
def test_a_weight_change_between_replays(cuda):
    """The graph reads the net's parameters by address: a change made in
    place between two calls (as the learner's update) changes the
    captured result exactly as it changes the eager one."""
    from alphatpu_torch import graphs

    game, net = _tiny_net(cuda)
    keep = [p.detach().clone() for p in net.parameters()]

    def nudged():
        """The same net for both calls, its weights changed in between."""
        yield net
        with torch.no_grad():
            net.res.mul_(-1.0)
            net.policy_b.add_(0.25)
        yield net

    outs = []
    for captured in (True, False):
        with torch.no_grad():
            for p, k in zip(net.parameters(), keep):
                p.copy_(k)
        graphs.clear_cache()
        outs.append(_selfplay_calls("continuous", game, nudged(), cuda,
                                    captured, False)[0])
    with torch.no_grad():
        for p, k in zip(net.parameters(), keep):
            p.copy_(k)
    graphs.clear_cache()
    unchanged = _selfplay_calls("continuous", game, (net, net), cuda, True,
                                False)[0]
    _equal(outs[0], outs[1])
    assert any(not torch.equal(x.cpu(), y.cpu())
               for x, y in zip(outs[0], unchanged))


@pytest.mark.cuda
def test_a_captured_call_hands_out_its_own_tensors(cuda):
    """The tail's outputs are the program's static tensors: a call copies
    them out, so a carry or stats held from an earlier call stay as they
    were; and a new buffer gets a tail of its own (the graph writes the
    buffer by address)."""
    from alphatpu_torch import graphs
    from alphatpu_torch.buffer import create_buffer
    from alphatpu_torch.selfplay import (
        SelfplayConfig, make_carry, selfplay_continuous,
    )

    game, net = _tiny_net(cuda)
    cfg = SelfplayConfig(**_SMALL, temp_moves=3, rounds=6)
    graphs.clear_cache()
    carry = make_carry(game, cfg.num_games,
                       torch.Generator(device=cuda).manual_seed(2), cuda)
    bufs = [create_buffer(game, 4096, device=cuda) for _ in range(2)]
    held = []
    for i in range(4):
        graphs.reset_counts()
        _, stats, carry = selfplay_continuous(game, net, bufs[i // 3], None,
                                              cfg, carry)
        # call 0 captures round and tail, calls 1-2 replay, call 3 has a
        # new buffer: its tail runs eagerly and is captured
        assert graphs.counts["captures"] == (2, 0, 0, 1)[i]
        held.append(([x.clone() for x in (carry.count, carry.enc,
                                          carry.pol, *carry.positions)],
                     {k: v.clone() for k, v in stats.items()},
                     carry, stats))
    for copies, stat_copies, old, old_stats in held:
        now = [old.count, old.enc, old.pol, *old.positions]
        assert all(torch.equal(a, b) for a, b in zip(copies, now))
        assert all(torch.equal(stat_copies[k], old_stats[k])
                   for k in old_stats)
    assert int(bufs[1].total[0]) > 0
    graphs.clear_cache()


@pytest.mark.cuda
def test_captured_evaluation_and_play_equal_eager(cuda):
    """eval_vs_random, eval_vs_probe (picks, trace) and the interactive
    engine (actions, pi): replayed from CUDA graphs, equal to their eager
    runs from the same generator state bit for bit, launches as owed."""
    import numpy as np

    from alphatpu_torch import graphs
    from alphatpu_torch.eval import EvalConfig, eval_vs_random
    from alphatpu_torch.interactive import make_engine
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.probe import eval_vs_probe

    game, net = _tiny_net(cuda)
    outs = []
    for captured in (True, False):
        graphs.clear_cache()
        graphs.reset_counts()
        K.reset_launch_counts()
        gen = torch.Generator(device=cuda).manual_seed(7)
        wdl = eval_vs_random(game, net, gen, EvalConfig(num_games=16,
                                                        rollouts=8),
                             device=cuda, captured=captured)
        w, d, l, trace = eval_vs_probe(game, net, gen, num_games=8,
                                       rollouts=8, trace=True, device=cuda,
                                       captured=captured)
        choose = make_engine(game, net, 16, 1.5, captured=captured)
        pos = game.initial(1, cuda)
        moves = []
        for _ in range(3):
            action, pi = choose(pos, gen)
            moves.append((action, pi))
            pos = game.play(pos, torch.tensor([action], device=cuda))
        plies = len(trace["records"])
        assert K.launch_counts()["select_apply_packed"] == (
            (2 * 9 * 8 + plies * 8 + 3 * 16), 0)
        outs.append((wdl, (w, d, l), trace, moves, gen.get_state(),
                     dict(graphs.counts)))
    cap, eager = outs
    assert cap[0] == eager[0] and cap[1] == eager[1]
    for a, b in zip(cap[2]["records"], eager[2]["records"]):
        for k in ("action", "greedy", "sampled", "alive"):
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(cap[2]["result"], eager[2]["result"])
    for (a, pa), (b, pb) in zip(cap[3], eager[3]):
        assert a == b and torch.equal(pa, pb)
    assert torch.equal(cap[4], eager[4])
    # eval: one program for both halves; probe: net move and apply
    assert cap[5]["captures"] == 4 and eager[5]["captures"] == 0
    graphs.clear_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["full", "no-select", "no-backup", "no-nn",
                                  "no-expand", "select-only"])
def test_captured_ablation_equals_eager(name, cuda):
    """Each ablation variant's move replayed from a CUDA graph leaves the
    tree its eager moves leave, bit for bit, with the launches owed."""
    from alphatpu_torch.benchmarks import ablate_rollout
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game

    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game, width=32, depth=2), 0,
                        device=cuda)
    positions = game.initial(64, cuda)
    variant = ablate_rollout.VARIANTS[name]
    outs = []
    for captured in (True, False):
        tree = init_tree(game, positions, 16)
        gen = torch.Generator(device=cuda).manual_seed(3)
        _, counted = ablate_rollout.time_variant(
            game, net, tree, positions, gen, 16, variant, moves=2,
            captured=captured)
        assert counted == ablate_rollout.owed_launches(game, variant,
                                                        16, 2)
        outs.append([tree.prior, tree.wsum, tree.visits, tree.parent,
                     tree.action_from, tree.expanded, tree.next_idx,
                     gen.get_state()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
