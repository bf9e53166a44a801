"""The port's search (``run_mcts``) against the reference's engines.

The reference runs its kernel path - ``fused_body_packed`` (level 1),
``fused_body_packed1`` (level 2) or ``fused_body`` (f32), each with its
Pallas kernel in the interpreter (``ALPHATPU_FORCE_INTERPRET=1``), and the
``backup_pallas`` flush - and the port its rollout loop with the plain
kernel versions, from a reset connect4 tree with the same injected uniforms
``probs[R, D, G]``.

Both nets get the same weights, drawn from {-1/8, 0, 1/8}: at width 32 and
depth 2 every product and partial sum of the forward is then a multiple of
2**-12 below 2**11, exact in float32 in any summation order, so the nets
agree up to the rounding of exp and sigmoid.  Tolerances: tree structure,
states and the packed-derived stats (wsum, visits) exactly; prior rows and
the root policy to rtol 1e-5 (softmax rounding, Newton sum order); at most
1 lane in 128 may diverge (a CDF prefix-sum tie), and the test prints it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.games import make_game as jax_make_game
from alphatpu.mcts.search import run_mcts as jax_run_mcts
from alphatpu.mcts.tree import init_tree as jax_init_tree
from alphatpu.nets import apply_inference
from alphatpu.selfplay import broadcast_initial
from alphatpu_torch.games import make_game
from alphatpu_torch.mcts import kernels as K
from alphatpu_torch.mcts.search import engine_level, run_mcts
from alphatpu_torch.mcts.tree import child_lookup, init_tree, reset_tree
from alphatpu_torch.nets import config_for_game, params_from_jax

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

CPUCT = 1.5


def dyadic_params(cfg, seed):
    """Weights in {-1/8, 0, 1/8} and zero biases (see the module doc)."""
    rng = np.random.default_rng(seed)
    shapes = {
        "base": (cfg.in_dim, cfg.width), "res": (cfg.depth, cfg.width,
                                                 cfg.width),
        "policy_w": (cfg.width, cfg.actions), "policy_b": (cfg.actions,),
        "value_w": (cfg.width, 1), "value_b": (1,),
        "feature_w": (cfg.width, cfg.fsize), "feature_b": (cfg.fsize,),
    }
    return {k: (np.zeros(s, np.float32) if k.endswith("_b") else
                (rng.integers(-1, 2, size=s) / 8).astype(np.float32))
            for k, s in shapes.items()}


def _searches(G, V, R, seed, final_root_policy, monkeypatch,
              packed_stats=None, name="connect4", bf16_stats=False):
    jgame, game = jax_make_game(name), make_game(name)
    cfg = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg, seed)
    D = min(game.max_game_length, V)
    probs = np.random.default_rng(seed + 1).random((R, D, G),
                                                   dtype=np.float32)

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jtree, jpi = jax_run_mcts(
        jgame, apply_inference, {k: jnp.asarray(v) for k, v in flat.items()},
        jax_init_tree(jgame, broadcast_initial(jgame, G), V,
                      stat_dtype=jnp.bfloat16 if bf16_stats else jnp.float32),
        None, rollouts=R, cpuct=CPUCT, training=True,
        probs=jnp.asarray(probs), final_root_policy=final_root_policy,
        packed_stats=packed_stats)
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")

    tree = init_tree(game, game.initial(G), V, stat_dtype=(
        torch.bfloat16 if bf16_stats else torch.float32))
    _, pi = run_mcts(game, params_from_jax(flat, cfg), tree, rollouts=R,
                     cpuct=CPUCT, training=True,
                     probs=torch.from_numpy(probs),
                     final_root_policy=final_root_policy,
                     packed_stats=packed_stats)
    return jax.device_get((jtree, jpi)), (tree, pi)


def _f64(x):
    """A torch tensor or a (JAX or numpy) array of any dtype, bf16
    included, as float64 numpy: exact for every stored value."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def _bf16_steps(x):
    """A bf16 plane of either package as int64 bit patterns: for values of
    one sign, the difference of two is the number of bf16 steps between
    them."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int64)
    return np.asarray(x).view(np.int16).astype(np.int64)


def _assert_trees_match(tree, jtree, pi, jpi, exact_prior=False):
    """Every tree field equal outside the CDF-tie lanes (at most 1 in 128,
    printed); prior rows and the root policy to rtol 1e-5 unless
    ``exact_prior``.

    On bf16 stat planes a prior entry is the net's f32 prior rounded once
    to bf16, and the two frameworks' softmax may differ by an f32 ulp: a
    value next to a rounding boundary then lands one bf16 step away.  So
    there each stored prior must be equal or one bf16 step apart (the
    counterpart of rtol 1e-5); a lane whose root row is a step apart has
    another root policy and counts as diverged."""
    G = tree.num_games
    bf16 = tree.prior.dtype == torch.bfloat16
    steps = (np.abs(_bf16_steps(tree.prior) - _bf16_steps(jtree.prior))
             if bf16 else None)
    exact = {
        "parent": (tree.parent, jtree.parent),
        "action_from": (tree.action_from, jtree.action_from),
        "expanded": (tree.expanded, jtree.expanded),
        "next_idx": (tree.next_idx, jtree.next_idx),
        "wsum": (tree.wsum, jtree.wsum),
        "visits": (tree.visits, jtree.visits),
    }
    if exact_prior:
        exact["prior"] = (tree.prior, jtree.prior)
    for i, (p, j) in enumerate(zip(tree.states, jtree.states)):
        exact[f"states[{i}]"] = (p, j)
    bad = {}
    for name, (p, j) in exact.items():
        p, j = _f64(p), _f64(j)
        for g in np.flatnonzero((p != j).reshape(-1, G).any(0)):
            bad.setdefault(int(g), []).append(name)
    if bf16:
        for g in np.flatnonzero(steps[:, 0, :].any(0)):
            bad.setdefault(int(g), []).append("prior[root]")
    if bad:
        print(f"diverged lanes (CDF-tie class): {bad}")
    assert len(bad) <= G // 128, bad
    ok = np.setdiff1d(np.arange(G), list(bad))
    for name, (p, j) in exact.items():  # float64 holds every value exactly
        np.testing.assert_array_equal(_f64(p)[..., ok], _f64(j)[..., ok],
                                      err_msg=name)
    if bf16:
        assert steps[..., ok].max() <= 1
        stepped = np.flatnonzero(steps[..., ok].reshape(-1, len(ok)).any(0))
        print(f"lanes with a prior one bf16 step apart: {ok[stepped]}")
    else:
        np.testing.assert_allclose(_f64(tree.prior)[..., ok],
                                   _f64(jtree.prior)[..., ok],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pi.numpy()[:, ok], np.asarray(jpi)[:, ok],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("final_root_policy", [False, True])
def test_run_mcts_matches_reference(final_root_policy, monkeypatch):
    G, V = 128, 16
    (jtree, jpi), (tree, pi) = _searches(G, V, V, 0, final_root_policy,
                                         monkeypatch)
    _assert_trees_match(tree, jtree, pi, jpi)
    # a real search happened: the tree filled up, and every rollout after
    # the first (which expands the root) crossed one root edge
    assert (tree.next_idx.numpy() > V // 2).mean() > 0.9
    np.testing.assert_array_equal(tree.visits[:, 0, :].sum(0).numpy(), V - 1)


@pytest.mark.parametrize("packed_stats,final_root_policy", [
    (2, False), (2, True), (False, False), (False, True),
])
def test_run_mcts_engines_match_reference(packed_stats, final_root_policy,
                                          monkeypatch):
    """Level 2 (the 1-plane word) and the f32 engine, each against the
    reference's kernel path.  At level 2 the prior rows are on the 1/2048
    grid and compared exactly; visits are integers, wsum lies on the
    1/S1 grid; the f32 engine's wsum lies on no grid."""
    G, V = 128, 16
    (jtree, jpi), (tree, pi) = _searches(G, V, V, 1, final_root_policy,
                                         monkeypatch, packed_stats)
    _assert_trees_match(tree, jtree, pi, jpi, exact_prior=packed_stats == 2)
    np.testing.assert_array_equal(tree.visits[:, 0, :].sum(0).numpy(), V - 1)
    visits = tree.visits.numpy().astype(np.float64)
    np.testing.assert_array_equal(visits % 1.0, 0.0)
    wsum = tree.wsum.numpy().astype(np.float64)
    if packed_stats == 2:
        _, _, s = K.packed1_layout(V)
        np.testing.assert_array_equal((wsum * s) % 1.0, 0.0)
        np.testing.assert_array_equal(
            (tree.prior.numpy().astype(np.float64) * 2048) % 1.0, 0.0)
    else:
        assert ((wsum * K.value_scale(V)) % 1.0 != 0.0).any()


def test_pregrown_search_matches_reference(monkeypatch):
    """A fresh level-1 search, then a second search of the same tree with
    ``segment_rollouts=False``: the auto level takes the f32 engine in
    both packages, and the tree fills up (leaf == V lanes)."""
    G, V, R1, R2 = 128, 24, 12, 16
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg, 5)
    net = params_from_jax(flat, cfg)
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    D = min(game.max_game_length, V)
    rng = np.random.default_rng(6)
    p1 = rng.random((R1, D, G), dtype=np.float32)
    p2 = rng.random((R2, D, G), dtype=np.float32)
    kw = dict(cpuct=CPUCT, training=True)

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jtree, _ = jax_run_mcts(
        jgame, apply_inference, jparams,
        jax_init_tree(jgame, broadcast_initial(jgame, G), V), None,
        rollouts=R1, probs=jnp.asarray(p1), **kw)
    jtree, jpi = jax_run_mcts(jgame, apply_inference, jparams, jtree, None,
                              rollouts=R2, probs=jnp.asarray(p2),
                              segment_rollouts=False, **kw)
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")
    jtree, jpi = jax.device_get((jtree, jpi))

    tree = init_tree(game, game.initial(G), V)
    run_mcts(game, net, tree, rollouts=R1, probs=torch.from_numpy(p1), **kw)
    with pytest.raises(ValueError, match="freshly reset"):
        run_mcts(game, net, tree, rollouts=R2, probs=torch.from_numpy(p2),
                 segment_rollouts=False, packed_stats=True, **kw)
    calls = _spy(monkeypatch, "select_apply_plain")
    _, pi = run_mcts(game, net, tree, rollouts=R2, probs=torch.from_numpy(p2),
                     segment_rollouts=False, **kw)
    assert calls == {"select_apply_plain": R2}
    _assert_trees_match(tree, jtree, pi, jpi)
    assert (tree.next_idx.numpy() > V).any()  # full trees were reached
    np.testing.assert_array_equal(tree.visits[:, 0, :].sum(0).numpy(),
                                  R1 + R2 - 1)


def test_level1_and_level2_agree_on_visit_totals():
    """The same search at level 1 and level 2: the coarser grids may flip
    samples, but every rollout after the first crosses one root edge."""
    game = make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg, 7), cfg)
    G, V = 64, 16
    D = min(game.max_game_length, V)
    probs = torch.from_numpy(np.random.default_rng(8).random(
        (V, D, G), dtype=np.float32))
    totals = []
    for level in (1, 2):
        tree = init_tree(game, game.initial(G), V)
        run_mcts(game, net, tree, rollouts=V, cpuct=CPUCT, training=True,
                 probs=probs, packed_stats=level)
        totals.append(tree.visits[:, 0, :].sum(0))
    assert torch.equal(totals[0], totals[1])
    assert bool((totals[0] == V - 1).all())


PLAIN = ("select_apply_packed_plain", "select_apply_packed1_plain",
         "select_apply_plain")


def _spy(monkeypatch, *names):
    """Count the calls of the named plain kernel versions."""
    calls = {}
    for name in names:
        fn = getattr(K, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(K, name, spy)
    return calls


@pytest.mark.parametrize("env,kwargs,engine", [
    ({}, {}, "select_apply_packed_plain"),
    ({"ALPHATPU_PACK": "2"}, {}, "select_apply_packed1_plain"),
    ({"ALPHATPU_NO_PACK": "1"}, {}, "select_apply_plain"),
    ({"ALPHATPU_PACK": "2", "ALPHATPU_NO_PACK": "1"}, {},
     "select_apply_plain"),
    ({}, {"packed_stats": False}, "select_apply_plain"),
    ({"ALPHATPU_PACK": "2"}, {"packed_stats": 1},
     "select_apply_packed_plain"),
])
def test_switches_pick_engines(env, kwargs, engine, monkeypatch):
    """``ALPHATPU_PACK`` and ``ALPHATPU_NO_PACK``, read at each call, and
    an explicit ``packed_stats`` pick the engine as in the reference
    (search.py:474-505); on the CPU the engine's plain version runs."""
    game = make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg, 0), cfg)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = _spy(monkeypatch, *PLAIN)
    tree = init_tree(game, game.initial(8), 8)
    run_mcts(game, net, tree, rollouts=8, cpuct=CPUCT, training=True,
             generator=torch.Generator().manual_seed(0), **kwargs)
    assert calls == {engine: 8}
    assert all(k.launches == 0 for k in K.KERNELS)


def test_run_mcts_engine_contract(monkeypatch):
    """The reference's contract: an explicit level >= 1 on a pre-grown
    tree raises; the auto level takes the f32 engine there; stat planes of
    mixed dtypes and unknown levels raise; level 2 is refused where one
    search's sums would not fit the word."""
    for ps in (True, 1, 2):
        with pytest.raises(ValueError, match="freshly reset"):
            engine_level(ps, segment_rollouts=False)
    assert engine_level(None, segment_rollouts=False) == 0
    assert engine_level(False, segment_rollouts=False) == 0
    assert engine_level(None, segment_rollouts=True) == 1
    assert engine_level(True, segment_rollouts=True) == 1
    monkeypatch.setenv("ALPHATPU_PACK", "2")
    assert engine_level(None, segment_rollouts=True) == 2
    assert engine_level(None, segment_rollouts=False) == 0
    monkeypatch.setenv("ALPHATPU_PACK", "3")
    with pytest.raises(ValueError, match="level 3"):
        engine_level(None, segment_rollouts=True)
    monkeypatch.delenv("ALPHATPU_PACK")

    game = make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg, 0), cfg)
    tree = init_tree(game, game.initial(8), 8)
    kw = dict(rollouts=8, cpuct=CPUCT, training=True,
              generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="fit the 1-plane word"):
        run_mcts(game, net, tree, packed_stats=2,
                 **dict(kw, rollouts=1024))
    tree.wsum = tree.wsum.to(torch.bfloat16)
    for ps in (None, False, 2):
        with pytest.raises(ValueError, match="f32"):
            run_mcts(game, net, tree, packed_stats=ps, **kw)


def test_tree_reset_in_place_and_child_lookup():
    """reset_tree refills the pool it is given; child_lookup finds each
    allocated edge's child and 0 elsewhere."""
    game = make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg, 1), cfg)
    G, V = 32, 16
    tree = init_tree(game, game.initial(G), V)
    run_mcts(game, net, tree, rollouts=V, cpuct=CPUCT, training=True,
             generator=torch.Generator().manual_seed(3))
    assert K.select_apply_packed.launches == 0  # CPU: plain versions
    for v in range(1, V):
        alloc = tree.parent[v] >= 0
        cid = child_lookup(tree.parent, tree.action_from, tree.parent[v],
                           tree.action_from[v])
        np.testing.assert_array_equal(cid[alloc].numpy(), v)
    # the last allocated node of each game has no children yet
    last = tree.next_idx - 1
    for a in range(game.max_actions):
        none = child_lookup(tree.parent, tree.action_from, last,
                            torch.full((G,), a, dtype=torch.int32))
        assert int(none.abs().sum()) == 0
    prior = tree.prior
    positions = game.play(game.initial(G), torch.full((G,), 3))
    out = reset_tree(tree, positions)
    assert out is tree and tree.prior is prior
    assert int(tree.prior.abs().sum()) == 0 and int(tree.visits.sum()) == 0
    assert bool((tree.parent == -1).all()) and bool((tree.next_idx == 1).all())
    root = type(positions)(*(leaf[0].movedim(-1, 0) for leaf in tree.states))
    for a, b in zip(root, positions):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["tictactoe", "reversi6x6", "hex5"])
def test_run_mcts_new_games_match_reference(name, monkeypatch):
    """Level 1 (the packed engine, the reference's kernel path) on the
    other families' action counts: 9, 37 with the pass column, 25 on an
    embedded 6x6 board."""
    G, V = 128, 16
    (jtree, jpi), (tree, pi) = _searches(G, V, V, 2, False, monkeypatch,
                                         name=name)
    _assert_trees_match(tree, jtree, pi, jpi)
    np.testing.assert_array_equal(tree.visits[:, 0, :].sum(0).numpy(), V - 1)


def _port_state(game, ost):
    """The port's batched state (G = 1) of a numpy-oracle state."""
    from alphatpu_torch import bitboard as bb

    spec = game.spec
    bp, bo = (bb.from_planes(spec, torch.from_numpy(
        ost[k].T.reshape(-1).astype(np.int64)))[None] for k in ("mover",
                                                                 "other"))
    player = torch.tensor([ost["player"]], dtype=torch.int8)
    zero = torch.zeros((1,), dtype=torch.int32)
    return type(game.initial(1))(bp, bo, player, zero)


@pytest.mark.parametrize("name", ["connect4", "tictactoe"])
def test_search_matches_scalar_twin(name):
    """Node for node against ``alphatpu.cpu_mcts.ScalarMCTS`` (numpy, the
    reference GPU algorithm one game at a time) on the same injected
    uniforms, from random openings, with a uniform-prior, value-0.5 net:
    tree structure, visits and child ids exactly, q and the root policy to
    the scalar twin's tolerances (rtol 2e-3 and 5e-3: float32 sums in
    another order and the Newton stop)."""
    from alphatpu import cpu_mcts, oracles

    from alphatpu_torch.mcts.tree import child_lookup

    game = make_game(name)
    oracle = (oracles.OracleConnect4() if name == "connect4" else
              oracles.OracleGobang(3, 3))
    G, R, cpuct = 6, 24, 1.5
    D = min(game.max_game_length, R)
    A = game.max_actions
    rng = np.random.default_rng(3)
    roots = []
    for _ in range(G):
        ost = oracle.initial()
        for _ in range(int(rng.integers(0, 6))):
            acts = oracle.legal_actions(ost)
            nxt = oracle.play(ost, int(acts[rng.integers(len(acts))]))
            if oracle.is_over(nxt)[0]:
                break
            ost = nxt
        roots.append(ost)
    states = [_port_state(game, o) for o in roots]
    positions = type(states[0])(*(torch.cat(x) for x in zip(*states)))
    probs = rng.random((R, D, G), dtype=np.float32)

    def uniform_net(x):
        return (torch.zeros((x.shape[0], A)),
                torch.full((x.shape[0],), 0.5))

    tree = init_tree(game, positions, R)
    _, pi = run_mcts(game, uniform_net, tree, rollouts=R, cpuct=cpuct,
                     training=True, probs=torch.from_numpy(probs))
    q = torch.where(tree.visits > 0,
                    tree.wsum / torch.clamp_min(tree.visits, 1.0), 0.0)
    uni = np.full(A, np.float32(1.0) / np.float32(A))
    twin = cpu_mcts.ScalarMCTS(oracle, A, cpuct, True,
                               prior_fn=lambda s: uni,
                               value_fn=lambda s: np.float32(0.5))
    for g in range(G):
        nodes, pol = twin.search(roots[g], probs[:, :, g])
        assert int(tree.next_idx[g]) == len(nodes), f"game {g} node count"
        for i, node in enumerate(nodes):
            assert int(tree.parent[i, g]) == node.parent, (g, i)
            if i > 0:
                assert int(tree.action_from[i, g]) == node.action_from, (g, i)
            assert bool(tree.expanded[i, g]) == node.expanded, (g, i)
            np.testing.assert_array_equal(tree.visits[:, i, g].numpy(),
                                          node.visits, err_msg=f"{g} {i}")
            np.testing.assert_allclose(q[:, i, g].numpy(), node.q, rtol=2e-3,
                                       atol=1e-5, err_msg=f"q {g} {i}")
            for a, c in node.child.items():
                cid = child_lookup(tree.parent, tree.action_from,
                                   torch.full((G,), i, dtype=torch.int32),
                                   torch.full((G,), a, dtype=torch.int32))
                assert int(cid[g]) == c, (g, i, a)
        np.testing.assert_allclose(pi[:, g].numpy(), pol, rtol=5e-3,
                                   atol=1e-5, err_msg=f"policy {g}")
