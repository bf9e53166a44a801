"""bf16 stat storage (``ALPHATPU_BF16_STATS``) in the port against the
reference.

Under the switch both packages store a search's prior, wsum and visits as
bf16 planes (``tree.stat_dtype_for``) and run the engine of the f32 family
on them: ``select_apply`` and ``backup`` (and ``select`` in the per-phase
API) read every row as f32 and round a stored value once to bf16, at each
backup add and each prior-row write.  The reference runs its kernel path
(Pallas in the interpreter, ``ALPHATPU_FORCE_INTERPRET=1``) on the same
injected uniforms and {-1/8, 0, 1/8} weights (test_torch_search).

Tolerances, those of test_torch_search: the tree structure, states, wsum
and visits exactly, and at most 1 lane in 128 diverged (a CDF prefix-sum
tie); a stored prior equal or one bf16 step apart (the frameworks' softmax
may differ by an f32 ulp, which rounding to bf16 can carry one step), a
root row one step apart counting as a diverged lane; the root policy to
rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.games import make_game as jax_make_game
from alphatpu.mcts import search as JS
from alphatpu.mcts.tree import init_tree as jax_init_tree
from alphatpu.mcts.tree import stat_dtype_for as jax_stat_dtype_for
from alphatpu.nets import apply_inference
from alphatpu.selfplay import broadcast_initial
from alphatpu_torch import eval as port_eval
from alphatpu_torch import probe
from alphatpu_torch.buffer import create_buffer
from alphatpu_torch.duel import DuelConfig, duel_network
from alphatpu_torch.games import make_game
from alphatpu_torch.interactive import make_engine
from alphatpu_torch.mcts import kernels as K
from alphatpu_torch.mcts import search as S
from alphatpu_torch.mcts.tree import init_tree, reset_tree, stat_dtype_for
from alphatpu_torch.nets import MLP, config_for_game, params_from_jax
from alphatpu_torch.selfplay import (
    SelfplayConfig, selfplay_continuous, selfplay_generation,
)

from test_torch_search import (
    _assert_trees_match, _searches, _spy, dyadic_params,
)

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

CPUCT = 1.5


@pytest.mark.parametrize("env", [None, "1"])
def test_stat_dtype_for_matches_reference(env, monkeypatch):
    """The cases of tests/test_pallas.py's test_stat_dtype_for and their
    neighbours: bf16 only under the switch, for at most 256 rollouts and a
    multiple of 16."""
    if env:
        monkeypatch.setenv("ALPHATPU_BF16_STATS", env)
    else:
        monkeypatch.delenv("ALPHATPU_BF16_STATS", raising=False)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    for rollouts in (8, 16, 32, 64, 100, 128, 240, 256, 272, 512):
        ours = stat_dtype_for(rollouts)
        assert names[ours] == jnp.dtype(jax_stat_dtype_for(rollouts)).name
        assert ours == (torch.bfloat16 if env and rollouts in (
            16, 32, 64, 128, 240, 256) else torch.float32)


def test_init_and_reset_keep_the_stat_dtype():
    game = make_game("connect4")
    tree = init_tree(game, game.initial(4), 16, stat_dtype=torch.bfloat16)
    for plane in (tree.prior, tree.wsum, tree.visits):
        assert plane.dtype == torch.bfloat16
        plane.fill_(1.0)
    reset_tree(tree, game.initial(4))
    for plane in (tree.prior, tree.wsum, tree.visits):
        assert plane.dtype == torch.bfloat16
        assert not bool(plane.any())
    assert init_tree(game, game.initial(4), 16).prior.dtype == torch.float32


@pytest.mark.parametrize("name", ["tictactoe", "hex5"])
def test_run_mcts_bf16_stats_matches_reference(name, monkeypatch):
    """tests/test_pallas.py's bf16 sizes (256 lanes, 32 rollouts on 32
    nodes): the reference's fused bf16 kernel path against the port's
    level-0 engine on bf16 planes."""
    G, V = 256, 32
    (jtree, jpi), (tree, pi) = _searches(G, V, V, 2, False, monkeypatch,
                                         name=name, bf16_stats=True)
    for plane in (tree.prior, tree.wsum, tree.visits):
        assert plane.dtype == torch.bfloat16
    assert jnp.dtype(jtree.prior.dtype) == jnp.bfloat16
    _assert_trees_match(tree, jtree, pi, jpi)
    np.testing.assert_array_equal(
        tree.visits[:, 0, :].float().sum(0).numpy(), V - 1)


def _port_phase_search(game, net, tree, probs):
    """The per-phase API, one rollout at a time (select -> leaf_positions
    -> net -> expand -> backup); returns the last rollout's root policy."""
    root_pi = None
    for p in probs:
        was = tree.expanded[0].clone()
        path, node, leaf_action, alloc, pi = S.select(game, tree, p, CPUCT)
        leaf_states = S.leaf_positions(game, tree, node, leaf_action, alloc)
        with torch.no_grad():
            logits, v = net(game.encode(leaf_states))
        prior = torch.softmax(logits, dim=-1).T.contiguous()
        _, done, result, newp = S.expand(game, tree, node, leaf_action,
                                         alloc, leaf_states, prior, True)
        root_pi = torch.where(was[None, :], pi, newp)
        S.backup(tree, path, leaf_states.player, v, done, result)
    return root_pi


@jax.jit
def _jax_phase_rollout(params, tree, p):
    """The reference's per-phase rollout (search.select, leaf_positions,
    expand with its prior write, backup) on connect4."""
    game = jax_make_game("connect4")
    was = tree.expanded[0]
    path, node, leaf_action, alloc, pi = JS.select(game, tree, p, CPUCT)
    leaf_states = JS.leaf_positions(game, tree, node, leaf_action, alloc)
    logits, v = apply_inference(params, jax.vmap(game.encode)(leaf_states))
    prior = jax.nn.softmax(logits, axis=-1).T
    tree, _, done, result, newp = JS.expand(
        game, tree, node, leaf_action, alloc, leaf_states, prior, True)
    tree = JS.backup(tree, path, leaf_states.player, v, done, result)
    return tree, jnp.where(was[None, :], pi, newp)


def test_per_phase_api_on_bf16_stats(monkeypatch):
    """search.select / expand / backup on a bf16 tree: against the
    reference's per-phase rollouts on a bf16 tree (the tolerances of the
    module doc), and bit for bit against the port's own run_mcts on the
    same uniforms (the level-0 engine defers the same writes)."""
    G, V = 128, 16
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg, 11)
    net = params_from_jax(flat, cfg)
    D = min(game.max_game_length, V)
    probs = np.random.default_rng(12).random((V, D, G), dtype=np.float32)

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jtree = jax_init_tree(jgame, broadcast_initial(jgame, G), V,
                          stat_dtype=jnp.bfloat16)
    params = {k: jnp.asarray(v) for k, v in flat.items()}
    for p in probs:
        jtree, jpi = _jax_phase_rollout(params, jtree, jnp.asarray(p))
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")
    jtree, jpi = jax.device_get((jtree, jpi))

    calls = _spy(monkeypatch, "select_plain", "backup_plain")
    tree = init_tree(game, game.initial(G), V, stat_dtype=torch.bfloat16)
    pi = _port_phase_search(game, net, tree, torch.from_numpy(probs))
    assert calls == {"select_plain": V, "backup_plain": V}
    assert tree.prior.dtype == torch.bfloat16
    _assert_trees_match(tree, jtree, pi, jpi)

    ref = init_tree(game, game.initial(G), V, stat_dtype=torch.bfloat16)
    _, ref_pi = S.run_mcts(game, net, ref, rollouts=V, cpuct=CPUCT,
                           training=True, probs=torch.from_numpy(probs))
    for f in ("parent", "action_from", "expanded", "next_idx", "prior",
              "wsum", "visits"):
        assert torch.equal(getattr(tree, f), getattr(ref, f)), f
    assert torch.equal(pi, ref_pi)


@pytest.mark.parametrize("packed_stats", [None, True, 2])
def test_bf16_stats_run_the_f32_family_engine(packed_stats, monkeypatch):
    """On bf16 planes every level asked for runs level 0 (the reference
    ignores packed_stats there, search.py:511-516), whatever
    ALPHATPU_PACK says; the planes stay bf16.  An explicit level on a
    pre-grown tree still raises."""
    bf16 = torch.bfloat16
    assert S.engine_level(packed_stats, True, bf16) == 0
    assert S.engine_level(packed_stats, True) == (
        1 if packed_stats is None else int(packed_stats))
    monkeypatch.setenv("ALPHATPU_PACK", "2")
    assert S.engine_level(packed_stats, True, bf16) == 0
    if packed_stats is None:
        assert S.engine_level(None, False, bf16) == 0
    else:
        with pytest.raises(ValueError, match="freshly reset"):
            S.engine_level(packed_stats, False, bf16)

    game = make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg, 0), cfg)
    calls = _spy(monkeypatch, "select_apply_packed_plain",
                 "select_apply_packed1_plain", "select_apply_plain",
                 "backup")
    tree = init_tree(game, game.initial(8), 16, stat_dtype=bf16)
    kw = dict(rollouts=16, cpuct=CPUCT, training=True,
              generator=torch.Generator().manual_seed(0))
    S.run_mcts(game, net, tree, packed_stats=packed_stats, **kw)
    assert calls == {"select_apply_plain": 16, "backup": 1}
    assert {t.dtype for t in (tree.prior, tree.wsum, tree.visits)} == {bf16}
    assert bool((tree.visits[:, 0, :].float().sum(0) == 15).all())
    if packed_stats is not None:
        with pytest.raises(ValueError, match="freshly reset"):
            S.run_mcts(game, net, tree, packed_stats=packed_stats,
                       segment_rollouts=False, **kw)
    else:  # a pre-grown bf16 tree: level 0, as on f32 planes
        S.run_mcts(game, net, tree, segment_rollouts=False, **kw)
        assert bool((tree.visits[:, 0, :].float().sum(0) == 31).all())


def test_bf16_wrappers_refuse_mixed_planes():
    A, V, G, D = 7, 8, 4, 8
    bf = torch.zeros((A, V, G), dtype=torch.bfloat16)
    f32 = torch.zeros((A, V, G))
    walk = (torch.full((V, G), -1, dtype=torch.int32),
            torch.zeros((V, G), dtype=torch.int32),
            torch.zeros((V, G), dtype=torch.bool), torch.rand((D, G)))
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        K.select(bf, f32, bf, *walk, CPUCT)
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        K.select_apply(bf, bf, f32, *walk, K.empty_pending(D, A, G), CPUCT)
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        K.backup(bf, f32, torch.full((D, G), -1, dtype=torch.int32),
                 torch.zeros((D, G), dtype=torch.int32),
                 torch.zeros((G,), dtype=torch.int32), torch.zeros(G))
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        K.backup(bf.half(), bf.half(), torch.full((D, G), -1,
                                                  dtype=torch.int32),
                 torch.zeros((D, G), dtype=torch.int32),
                 torch.zeros((G,), dtype=torch.int32), torch.zeros(G))


def _callers():
    """Every search caller of the port at a tiny size, 64 rollouts a
    search (the bf16 condition holds): name -> a function running it."""
    ttt = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(ttt, width=16, depth=1), 0)
    gen = torch.Generator().manual_seed(0)
    sp = SelfplayConfig(num_games=4, rollouts=64, max_moves=2, rounds=2)
    return {
        "selfplay_generation": lambda: selfplay_generation(
            ttt, net, create_buffer(ttt, 64), gen, sp),
        "selfplay_continuous": lambda: selfplay_continuous(
            ttt, net, create_buffer(ttt, 64), gen,
            sp._replace(continuous=True)),
        "duel": lambda: duel_network(
            ttt, net, net, gen, DuelConfig(num_games=4, rollouts=64,
                                           max_moves=2)),
        "eval_vs_random": lambda: port_eval.eval_vs_random(
            ttt, net, gen, port_eval.EvalConfig(num_games=4, max_moves=2),
            device="cpu"),
        "eval_vs_probe": lambda: probe.eval_vs_probe(
            ttt, net, gen, probe.probe_for_game(ttt, 2), num_games=2,
            rollouts=64, device="cpu"),
        "interactive": lambda: make_engine(ttt, net, 64, CPUCT)(
            ttt.initial(1), gen),
    }


@pytest.mark.parametrize("bf16", [False, True])
def test_every_search_caller_follows_the_switch(bf16, monkeypatch):
    """With ALPHATPU_BF16_STATS=1 each caller's search stores prior, wsum
    and visits as bf16 and runs the level-0 engine (select_apply, then the
    backup flush); without it the same calls keep f32 planes and level 1,
    as before the switch was ported."""
    if bf16:
        monkeypatch.setenv("ALPHATPU_BF16_STATS", "1")
    else:
        monkeypatch.delenv("ALPHATPU_BF16_STATS", raising=False)
    seen = []
    # the stat planes each spied function takes first: the packed walk's
    # f32 prior (its packed word is i32), backup's wsum and visits (the
    # wrapper: the flush of each search)
    for name, n_planes in (("select_apply_plain", 3),
                           ("select_apply_packed_plain", 1), ("backup", 2)):
        fn = getattr(K, name)

        def spy(*a, _fn=fn, _name=name, _n=n_planes, **kw):
            seen.append((_name, {t.dtype for t in a[:_n]}))
            return _fn(*a, **kw)

        monkeypatch.setattr(K, name, spy)
    for caller, run in _callers().items():
        seen.clear()
        run()
        walks = {n for n, _ in seen if n != "backup"}
        want = "select_apply_plain" if bf16 else "select_apply_packed_plain"
        assert walks == {want}, (caller, walks)
        dtype = torch.bfloat16 if bf16 else torch.float32
        assert all(d == {dtype} for _, d in seen), (caller, seen[:3])
        n_walks = sum(n != "backup" for n, _ in seen)
        assert n_walks == 64 * sum(n == "backup" for n, _ in seen) > 0


def test_wrappers_launch_the_bf16_entries(monkeypatch):
    """On device tensors (meta here, the launch captured) each three-plane
    wrapper calls its f32 or its bf16 entry by the planes' dtype, with the
    same arguments, and counts the launch under its name and, for bf16,
    in ``launches_bf16``."""
    meta = torch.device("meta")
    A, V, G, D = 7, 64, 8192, 42
    t = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=meta)
    i32 = torch.int32
    launched = []
    monkeypatch.setattr(K, "_on_cuda", lambda name, x: True)
    monkeypatch.setattr(K, "_launch", lambda entry, dev, *a: launched.append(
        (entry, len(a), a[-6:])))
    K.reset_launch_counts()
    walk = (t(V, G, dt=i32), t(V, G, dt=i32), t(V, G, dt=torch.bool),
            t(D, G))
    pend = K.PendingUpdate(t(D, G, dt=i32), t(D, G, dt=i32), t(G, dt=i32),
                           t(G), t(G, dt=i32), t(A, G), t(G, dt=torch.bool))
    path = (t(D, G, dt=i32), t(D, G, dt=i32), t(G, dt=i32), t(G))
    for dt in (torch.float32, torch.bfloat16):
        planes = [t(A, V, G, dt=dt) for _ in range(3)]
        K.select_apply(*planes, *walk, pend, CPUCT)
        K.select(*planes, *walk, CPUCT)
        K.backup(*planes[1:], *path)
    names = [e for e, _, _ in launched]
    assert names == ["launch_select_apply", "launch_select", "launch_backup",
                     "launch_select_apply_bf16", "launch_select_bf16",
                     "launch_backup_bf16"]
    for f32, bf in zip(launched[:3], launched[3:]):
        assert f32[1:] == bf[1:]  # the same arguments and geometry
    for k in (K.select_apply, K.select, K.backup):
        assert (k.launches, k.launches_bf16) == (2, 1)
