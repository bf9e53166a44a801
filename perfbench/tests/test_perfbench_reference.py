"""The reference's plain rules and search against the port's plain
versions, on the CPU at small sizes (the tests may import the port; the
reference does not)."""
import numpy as np
import pytest
import torch

from alphatpu_torch.games import make_game
from alphatpu_torch.mcts import newton
from alphatpu_torch.mcts.search import run_mcts
from alphatpu_torch.mcts.tree import init_tree
from alphatpu_torch.nets import MLP, NetConfig, apply_inference
from perfbench import generator
from perfbench.reference import games, net, search

torch.set_num_threads(1)


def _random_play(name, n, plies, seed):
    """Both sides' positions after ``plies`` random legal moves of ``n``
    games, checked ply by ply; returns the reference's and the port's."""
    ref, port = games.make(name), make_game(name)
    rng = np.random.default_rng(seed)
    me, opp, player = ref.initial(n)
    pos = port.initial(n)
    for _ in range(plies):
        enc = port.encode(pos).numpy()
        np.testing.assert_array_equal(enc, ref.encode(me, opp))
        np.testing.assert_array_equal(pos.player.numpy(), player)
        legal = ref.legal(me, opp)
        np.testing.assert_array_equal(port.legal_mask(pos).numpy(), legal)
        done, result = ref.is_over(me, opp, player)
        p_done, p_result = port.is_over(pos)
        np.testing.assert_array_equal(p_done.numpy(), done)
        np.testing.assert_array_equal(p_result.numpy(), result)
        np.testing.assert_array_equal(port.final_feature(pos).numpy(),
                                      ref.final_feature(me, player))
        scores = rng.random(legal.shape) * legal
        action = scores.argmax(-1)
        me, opp, player = ref.play(me, opp, player, action)
        pos = port.play(pos, torch.as_tensor(action, dtype=torch.int32))
    return me, opp, player, pos


@pytest.mark.parametrize("name,plies", [("reversi8x8", 64), ("reversi6x6", 36),
                                        ("gobang13", 60), ("gobang4", 16)])
def test_plain_rules_agree_with_the_port(name, plies):
    _random_play(name, 64, plies, seed=len(name))


def test_sums_run_in_action_order():
    x = np.random.default_rng(0).random((169, 37)).astype(np.float32) * 1e3
    acc = x[0].copy()
    for row in x[1:]:
        acc = acc + row
    np.testing.assert_array_equal(search.sum0(x), acc)


def test_cdf_sample_agrees_with_the_port():
    rng = np.random.default_rng(1)
    pi = rng.random((65, 200)).astype(np.float32)
    pi[rng.random(pi.shape) < 0.5] = 0
    pi[:, :3] = 0
    u = rng.random(200).astype(np.float32) * 40
    np.testing.assert_array_equal(
        search.cdf_sample(pi, u),
        newton.cdf_sample(torch.from_numpy(pi), torch.from_numpy(u)).numpy())


def test_net_agrees_with_the_port():
    ref = games.make("reversi8x8")
    shapes = generator.net_shapes(ref, 512, 8)
    w = generator.make_weights(shapes, 3, "cpu")
    model = MLP(NetConfig(128, 65, 64, 512, 8))
    with torch.no_grad():
        for k, v in w.items():
            getattr(model, k).copy_(v)
    x = torch.randint(0, 2, (32, 128)).float()
    logits, value = apply_inference(model, x)
    r_logits, r_value = net.forward({k: v.numpy() for k, v in w.items()},
                                    x.numpy())
    np.testing.assert_allclose(r_logits, logits.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(r_value, value.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["reversi8x8", "gobang13"])
def test_search_agrees_with_the_port(name, monkeypatch):
    monkeypatch.setenv("ALPHATPU_PACK", "1")
    monkeypatch.delenv("ALPHATPU_NO_PACK", raising=False)
    monkeypatch.delenv("ALPHATPU_BF16_STATS", raising=False)
    G, R = 12, 16
    ref, port = games.make(name), make_game(name)
    me, opp, player, pos = _random_play(name, G, 6, seed=7)
    shapes = generator.net_shapes(ref, 64, 2)
    w = generator.make_weights(shapes, 5, "cpu")
    model = MLP(NetConfig(2 * ref.cells, ref.actions, ref.cells, 64, 2))
    with torch.no_grad():
        for k, v in w.items():
            getattr(model, k).copy_(v)
    D = min(ref.max_length, R)
    probs = torch.rand((R, D, G), generator=torch.Generator().manual_seed(9))
    tree = init_tree(port, pos, R)
    _, pol = run_mcts(port, lambda x: apply_inference(model, x), tree,
                      rollouts=R, cpuct=1.5, training=True,
                      probs=probs)
    ref_pol = search.search(ref, {k: v.numpy() for k, v in w.items()},
                            me, opp, player, probs.numpy(), 1.5)
    gap = np.abs(ref_pol - pol.numpy()).max(0)
    assert (gap < 1e-5).sum() >= G - 1, gap


def test_every_seed_makes_one_function_in_another_order():
    ref = games.make("gobang13")
    shapes = generator.net_shapes(ref, 64, 2)
    a, b = (generator.make_weights(shapes, s, "cpu") for s in (3, 2**40))
    assert not torch.equal(a["res"], b["res"])
    x = np.random.default_rng(4).integers(0, 2, (16, 2 * ref.cells))
    (la, va), (lb, vb) = (net.forward({k: v.numpy() for k, v in w.items()},
                                      x) for w in (a, b))
    np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-6)
