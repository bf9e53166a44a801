"""The port's search (``run_mcts``) against the reference's packed engine.

The reference runs its production path - ``fused_body_packed`` with the
``select_apply_packed`` Pallas kernel in the interpreter
(``ALPHATPU_FORCE_INTERPRET=1``) and the ``backup_pallas`` flush - and the
port its rollout loop with the plain kernel versions, from a reset connect4
tree with the same injected uniforms ``probs[R, D, G]``.

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
from alphatpu_torch.mcts.search import run_mcts
from alphatpu_torch.mcts.tree import child_lookup, init_tree, reset_tree
from alphatpu_torch.nets import config_for_game, params_from_jax

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


def _searches(G, V, R, seed, final_root_policy, monkeypatch):
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg, seed)
    D = min(game.max_game_length, V)
    probs = np.random.default_rng(seed + 1).random((R, D, G),
                                                   dtype=np.float32)

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jtree, jpi = jax_run_mcts(
        jgame, apply_inference, {k: jnp.asarray(v) for k, v in flat.items()},
        jax_init_tree(jgame, broadcast_initial(jgame, G), V), None,
        rollouts=R, cpuct=CPUCT, training=True, probs=jnp.asarray(probs),
        final_root_policy=final_root_policy)
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")

    tree = init_tree(game, game.initial(G), V)
    _, pi = run_mcts(game, params_from_jax(flat, cfg), tree, rollouts=R,
                     cpuct=CPUCT, training=True,
                     probs=torch.from_numpy(probs),
                     final_root_policy=final_root_policy)
    return jax.device_get((jtree, jpi)), (tree, pi)


@pytest.mark.parametrize("final_root_policy", [False, True])
def test_run_mcts_matches_reference(final_root_policy, monkeypatch):
    G, V = 128, 16
    (jtree, jpi), (tree, pi) = _searches(G, V, V, 0, final_root_policy,
                                         monkeypatch)
    exact = {
        "parent": (tree.parent, jtree.parent),
        "action_from": (tree.action_from, jtree.action_from),
        "expanded": (tree.expanded, jtree.expanded),
        "next_idx": (tree.next_idx, jtree.next_idx),
        "wsum": (tree.wsum, jtree.wsum),
        "visits": (tree.visits, jtree.visits),
    }
    for i, (p, j) in enumerate(zip(tree.states, jtree.states)):
        exact[f"states[{i}]"] = (p, j)
    bad = {}
    for name, (p, j) in exact.items():
        p = p.numpy().astype(np.float64)
        j = np.asarray(j).astype(np.float64)
        for g in np.flatnonzero((p != j).reshape(-1, G).any(0)):
            bad.setdefault(int(g), []).append(name)
    if bad:
        print(f"diverged lanes (CDF-tie class): {bad}")
    assert len(bad) <= G // 128, bad
    ok = np.setdiff1d(np.arange(G), list(bad))
    for name, (p, j) in exact.items():  # float64 holds every value exactly
        np.testing.assert_array_equal(
            p.numpy()[..., ok].astype(np.float64),
            np.asarray(j)[..., ok].astype(np.float64), err_msg=name)
    np.testing.assert_allclose(tree.prior.numpy()[..., ok],
                               np.asarray(jtree.prior)[..., ok],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pi.numpy()[:, ok], np.asarray(jpi)[:, ok],
                               rtol=1e-5, atol=1e-6)
    # a real search happened: the tree filled up, and every rollout after
    # the first (which expands the root) crossed one root edge
    assert (tree.next_idx.numpy() > V // 2).mean() > 0.9
    np.testing.assert_array_equal(tree.visits[:, 0, :].sum(0).numpy(), V - 1)


def test_run_mcts_refuses_unported_engines():
    game = make_game("connect4")
    cfg = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg, 0), cfg)
    tree = init_tree(game, game.initial(8), 8)
    kw = dict(rollouts=8, cpuct=CPUCT, training=True,
              generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="packed level-1"):
        run_mcts(game, net, tree, packed_stats=2, **kw)
    with pytest.raises(ValueError, match="fresh tree"):
        run_mcts(game, net, tree, segment_rollouts=False, **kw)
    tree.prior = tree.prior.to(torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        run_mcts(game, net, tree, **kw)


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
