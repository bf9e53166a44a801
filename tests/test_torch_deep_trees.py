"""The port's level-1 search on deep, narrow 13x13 trees against the
reference's.

A trained gobang13 net's trees are deep and narrow; a net from a seed
grows shallow, broad ones from the initial position, and those are the
only 13x13 trees the other search tests hold.  Here the net's policy head
is scaled by 16 (weights in {-2, 0, 2}: still exact float32 products, see
test_torch_search), so its prior is sharp, and the roots are gobang13
positions after 20 random legal plies drawn with numpy
(``alphatpu_torch.mcts.deep_trees``).  Both packages search them from the
same injected uniforms: the reference's kernel path (``select_apply_packed``
in the Pallas interpreter, G = 128, V a multiple of 8) and the port's
level-1 engine on its plain versions.

Tolerances: tree structure, states, wsum and visits exactly; prior rows
and the root policy to rtol 1e-5 (softmax rounding, Newton sum order).
Allowance: at A = 169, 1 diverged lane in 512 (ROADMAP.md's standing
record), so none of 128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphatpu.games import make_game as jax_make_game
from alphatpu.mcts.search import run_mcts as jax_run_mcts
from alphatpu.mcts.tree import init_tree as jax_init_tree
from alphatpu.nets import apply_inference
from alphatpu.selfplay import broadcast_initial
from alphatpu_torch.games import make_game
from alphatpu_torch.mcts.deep_trees import (node_depths, opening_positions,
                                            sharpen)
from alphatpu_torch.mcts.search import run_mcts
from alphatpu_torch.mcts.tree import init_tree
from alphatpu_torch.nets import MLP, config_for_game, params_from_jax

from test_torch_search import _f64, dyadic_params

torch.set_num_threads(1)

CPUCT = 1.5
SHARPEN = 16  # the policy head's scale: a power of two keeps it exact
PLIES = 20  # random plies before the root
MIN_DEPTH = 12  # the smoke's deep-tree guard asks as much of the card


def test_deep_trees_match_reference(monkeypatch):
    G, V = 128, 32
    R = V
    jgame, game = jax_make_game("gobang13"), make_game("gobang13")
    cfg = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg, 0)
    flat["policy_w"] = flat["policy_w"] * SHARPEN
    pos, actions = opening_positions(game, G, PLIES, 1)
    jpos = broadcast_initial(jgame, G)
    for a in actions:
        jpos = jax.vmap(jgame.play)(jpos, jnp.asarray(a))
    D = min(game.max_game_length, V)
    probs = np.random.default_rng(2).random((R, D, G), dtype=np.float32)

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jtree, jpi = jax_run_mcts(
        jgame, apply_inference, {k: jnp.asarray(v) for k, v in flat.items()},
        jax_init_tree(jgame, jpos, V), None, rollouts=R, cpuct=CPUCT,
        training=True, probs=jnp.asarray(probs))
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")
    jtree, jpi = jax.device_get((jtree, jpi))

    tree = init_tree(game, pos, V)
    _, pi = run_mcts(game, params_from_jax(flat, cfg), tree, rollouts=R,
                     cpuct=CPUCT, training=True, probs=torch.from_numpy(probs))

    depth = node_depths(tree.parent)
    print(f"depth reached: largest {depth.max()}, mean of each lane's "
          f"largest {depth.max(0).mean():.2f}")
    assert depth.max() >= MIN_DEPTH
    np.testing.assert_array_equal(node_depths(jtree.parent), depth)

    exact = {f: (getattr(tree, f), getattr(jtree, f)) for f in (
        "parent", "action_from", "expanded", "next_idx", "wsum", "visits")}
    for i, (p, j) in enumerate(zip(tree.states, jtree.states)):
        exact[f"states[{i}]"] = (p, j)
    bad = np.zeros(G, bool)
    for p, j in exact.values():
        bad |= (_f64(p) != _f64(j)).reshape(-1, G).any(0)
    assert bad.sum() <= G // 512, np.flatnonzero(bad)
    for name, (p, j) in exact.items():
        np.testing.assert_array_equal(_f64(p), _f64(j), err_msg=name)
    np.testing.assert_allclose(_f64(tree.prior), _f64(jtree.prior),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pi.numpy(), np.asarray(jpi), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tree.visits[:, 0, :].sum(0).numpy(), R - 1)


def test_opening_positions_are_legal_and_seeded():
    game = make_game("gobang13")
    pos, actions = opening_positions(game, 16, PLIES, 3)
    again, same = opening_positions(game, 16, PLIES, 3)
    np.testing.assert_array_equal(actions, same)
    for x, y in zip(pos, again):
        assert torch.equal(x, y)
    # every ply put a stone on an empty cell, and no game is over
    for lane in range(16):
        assert len(set(actions[:, lane].tolist())) == PLIES
    stones = game.encode(pos).sum(1)
    np.testing.assert_array_equal(stones.numpy(), PLIES)
    assert not bool(game.is_over(pos)[0].any())
    assert bool((pos.round == PLIES).all())


def test_node_depths_and_sharpen():
    # two lanes: a chain 0-1-2-3 and a root with three children
    parent = np.array([[-1, -1], [0, 0], [1, 0], [2, 0]], np.int32)
    np.testing.assert_array_equal(node_depths(torch.from_numpy(parent)),
                                  [[0, 0], [1, 1], [2, 1], [3, 1]])
    game = make_game("gobang13")
    cfg = config_for_game(game, width=32, depth=2)
    x = game.encode(opening_positions(game, 4, 6, 0)[0])
    logits, value = MLP.from_seed(cfg, 0)(x)
    s_logits, s_value = sharpen(MLP.from_seed(cfg, 0), 4.0)(x)
    assert torch.equal(s_logits, logits * 4.0)
    assert torch.equal(s_value, value)


def test_sharpened_prior_walks_deeper():
    """The smoke's deep-tree shape at a small width: from the same
    mid-game positions and uniforms, the sharpened net's search reaches
    deeper than the same net's unscaled one, and at least MIN_DEPTH."""
    game = make_game("gobang13")
    cfg = config_for_game(game, width=32, depth=2)
    pos, _ = opening_positions(game, 8, PLIES, 0)
    reached = []
    for factor in (1.0, float(SHARPEN)):
        net = sharpen(MLP.from_seed(cfg, 0), factor)
        tree = init_tree(game, pos, 65)
        run_mcts(game, net, tree, rollouts=64, cpuct=CPUCT, training=True,
                 generator=torch.Generator().manual_seed(0))
        assert (tree.visits[:, 0, :].sum(0) == 63).all()
        depth = node_depths(tree.parent)
        reached.append(depth.max(0).mean())
        print(f"factor {factor}: depth largest {depth.max()}, mean of "
              f"each lane's largest {reached[-1]:.2f}")
    assert depth.max() >= MIN_DEPTH
    assert reached[1] > reached[0]
