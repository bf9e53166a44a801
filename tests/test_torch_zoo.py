"""The port's net zoo against ``alphatpu.nets.zoo``.

Every zoo net's forward equals the reference's apply with the same
(carried) weights, to rtol 1e-5 and atol 1e-6 (float32 matmul and
convolution rounding), on connect4 and hex5; the conv tower on connect4,
whose 6x7 board catches a transposed reshape or flatten.  Every net
round-trips through ``params_to_numpy`` / ``params_from_jax``.  A search
with res2 (weights in {-1/8, 0, 1/8}, exact float32 products at width 16,
see test_torch_search) equals the reference's ``run_mcts`` with the same
net and injected uniforms, within the CDF-tie allowance of 1 lane in 128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.games import make_game as jax_make_game
from alphatpu.mcts.search import run_mcts as jax_run_mcts
from alphatpu.mcts.tree import init_tree as jax_init_tree
from alphatpu.nets import config_for_game as jax_config_for_game
from alphatpu.nets import zoo as jax_zoo
from alphatpu.selfplay import broadcast_initial
from alphatpu_torch.games import make_game
from alphatpu_torch.mcts.search import run_mcts
from alphatpu_torch.mcts.tree import init_tree
from alphatpu_torch.nets import config_for_game
from alphatpu_torch.nets.zoo import (
    ZOO, ConvNet, conv_config, make_conv_net, make_net, params_from_jax,
    params_to_numpy,
)

from test_torch_search import _assert_trees_match

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

CPUCT = 1.5


def _inputs(game, n, seed):
    """n random encodings (0/1 planes), as the search gives the net."""
    return np.random.default_rng(seed).integers(
        0, 2, (n, 2 * game.vectorized_state)).astype(np.float32)


def _reference(name, jgame, width, depth, seed):
    """The reference's (numpy params, apply) of zoo net ``name``."""
    params, apply = jax_zoo.make_net(
        name, jax.random.key(seed),
        jax_config_for_game(jgame, width=width, depth=depth))
    return {k: np.asarray(v) for k, v in params.items()}, apply


def _assert_forward_equal(net, apply, flat, x):
    logits, value = net(torch.from_numpy(x))
    ref_logits, ref_value = apply({k: jnp.asarray(v) for k, v in flat.items()},
                                  jnp.asarray(x))
    assert logits.shape == ref_logits.shape and value.shape == ref_value.shape
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(ref_value),
                               rtol=1e-5, atol=1e-6)


def test_zoo_registry_matches_reference():
    assert set(ZOO) == set(jax_zoo.ZOO)


@pytest.mark.parametrize("game_name", ["connect4", "hex5"])
@pytest.mark.parametrize("name", sorted(jax_zoo.ZOO))
def test_zoo_forward_matches_reference(name, game_name):
    jgame, game = jax_make_game(game_name), make_game(game_name)
    flat, apply = _reference(name, jgame, 32, 2, seed=3)
    net = params_from_jax(name, flat, config_for_game(game, width=32,
                                                      depth=2))
    _assert_forward_equal(net, apply, flat, _inputs(game, 12, seed=4))


@pytest.mark.parametrize("channels,depth", [(8, 2), (16, 1)])
def test_conv_net_matches_reference(channels, depth):
    """connect4's 6x7 board: rows and columns differ, so a row-major
    reshape or an NCHW-ordered flatten changes the output."""
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    init, apply = jax_zoo.make_conv_net(jgame, channels=channels,
                                        depth=depth)
    flat = {k: np.asarray(v) for k, v in init(jax.random.key(5)).items()}
    net = params_from_jax("conv", flat, conv_config(game, channels, depth))
    assert net.stem.shape == (channels, 2, 3, 3)  # OIHW
    _assert_forward_equal(net, apply, flat, _inputs(game, 12, seed=6))


@pytest.mark.parametrize("name", sorted(ZOO) + ["conv"])
def test_zoo_round_trip_and_init(name):
    """A seeded net's parameters have the reference's names and shapes,
    come back unchanged through params_to_numpy / params_from_jax, and
    give the same forward in the reference's apply; the inits are finite
    and seeded."""
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    if name == "conv":
        cfg = conv_config(game, 8, 2)
        net = make_conv_net(game, 8, 2, seed=1)
        init, apply = jax_zoo.make_conv_net(jgame, channels=8, depth=2)
        ref = init(jax.random.key(0))
        other = make_conv_net(game, 8, 2, seed=2)
    else:
        cfg = config_for_game(game, width=32, depth=2)
        net = make_net(name, cfg, seed=1)
        ref, apply = jax_zoo.make_net(
            name, jax.random.key(0),
            jax_config_for_game(jgame, width=32, depth=2))
        other = make_net(name, cfg, seed=2)
    flat = params_to_numpy(net)
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in ref.items()}
    assert all(np.isfinite(v).all() for v in flat.values())
    assert any(not np.array_equal(v, params_to_numpy(other)[k])
               for k, v in flat.items())
    back = params_from_jax(name, flat, cfg)
    for k, v in params_to_numpy(back).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    x = _inputs(game, 8, seed=7)
    _assert_forward_equal(net, apply, flat, x)
    logits, value = back(torch.from_numpy(x))
    assert torch.equal(logits, net(torch.from_numpy(x))[0])
    assert bool(((value >= 0) & (value <= 1)).all())


@pytest.mark.parametrize("name", sorted(ZOO) + ["conv"])
def test_zoo_net_drives_search(name):
    """Each zoo net drops into run_mcts unchanged (tests/test_zoo.py's
    contract): a normalised root policy of shape [A, G]."""
    game = make_game("tictactoe")
    if name == "conv":
        net = make_conv_net(game, channels=8, depth=1, seed=0)
    else:
        net = make_net(name, config_for_game(game, width=16, depth=1), 0)
    tree = init_tree(game, game.initial(4), 8)
    _, pol = run_mcts(game, net, tree, rollouts=8, cpuct=CPUCT,
                      training=True, generator=torch.Generator().manual_seed(1))
    assert pol.shape == (game.max_actions, 4)
    assert bool(((pol.sum(0) - 1.0).abs() < 0.05).all())


def test_conv_net_is_a_module_of_the_zoo():
    game = make_game("connect4")
    net = make_conv_net(game)
    assert isinstance(net, ConvNet)
    assert net.cfg == conv_config(game, 64, 4)
    assert torch.backends.cudnn.allow_tf32 is False


def test_run_mcts_with_res2_matches_reference(monkeypatch):
    """connect4, 128 lanes, 16 rollouts, res2 (width 16, depth 1) with
    weights in {-1/8, 0, 1/8}: both packages' level-1 searches (the
    reference's Pallas kernels in the interpreter) on the same injected
    uniforms give the same trees and root policy."""
    G, R = 128, 16
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    cfg = config_for_game(game, width=16, depth=1)
    rng = np.random.default_rng(8)
    flat = {k: (np.zeros(v.shape, np.float32) if k.endswith("_b") else
                (rng.integers(-1, 2, size=v.shape) / 8).astype(np.float32))
            for k, v in params_to_numpy(make_net("res2", cfg, 0)).items()}
    D = min(game.max_game_length, R)
    probs = np.random.default_rng(9).random((R, D, G), dtype=np.float32)

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jtree, jpi = jax_run_mcts(
        jgame, jax_zoo.apply_res2, {k: jnp.asarray(v) for k, v in flat.items()},
        jax_init_tree(jgame, broadcast_initial(jgame, G), R), None,
        rollouts=R, cpuct=CPUCT, training=True, probs=jnp.asarray(probs))
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")

    tree = init_tree(game, game.initial(G), R)
    _, pi = run_mcts(game, params_from_jax("res2", flat, cfg), tree,
                     rollouts=R, cpuct=CPUCT, training=True,
                     probs=torch.from_numpy(probs))
    jtree, jpi = jax.device_get((jtree, jpi))
    _assert_trees_match(tree, jtree, pi, jpi)
