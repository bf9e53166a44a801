"""The port's ``eval_vs_random`` and ``ladder`` against ``alphatpu.eval``.

``_vs_random_half`` runs in both packages on the same uniforms: the test
recreates the reference's key stream (per ply: split the key into three,
the search draws one uniform block per rollout from the second, the random
mover one uniform per game from the third - the duel's pattern,
``test_torch_duel.duel_uniforms``) and feeds it to the port.  The net's
weights are in {-1/8, 0, 1/8}; both packages search with the f32 engine.
The four tallies must be equal.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from alphatpu import eval as jax_eval
from alphatpu.games import make_game as jax_make_game
from alphatpu.nets import apply_inference
from alphatpu.selfplay import broadcast_initial as jax_broadcast_initial
from alphatpu_torch.duel import DuelConfig, duel_network
from alphatpu_torch.eval import (
    EvalConfig, _vs_random_half, eval_vs_random, ladder, resolve_device,
)
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import MLP, config_for_game, params_from_jax

from test_torch_duel import duel_uniforms
from test_torch_selfplay import dyadic_params

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)


def test_eval_config_defaults_match_reference():
    assert tuple(EvalConfig()) == tuple(jax_eval.EvalConfig())
    assert EvalConfig._fields == jax_eval.EvalConfig._fields


@pytest.mark.parametrize("net_first,max_moves", [(True, None), (False, None),
                                                 (True, 6)])
def test_vs_random_half_matches_reference(net_first, max_moves, monkeypatch):
    """tictactoe, 16 games, 8 rollouts, every ply searched (a bound of 6
    plies leaves games unfinished): the port's tally equals the
    reference's."""
    G, R = 16, 8
    jgame, game = jax_make_game("tictactoe"), make_game("tictactoe")
    cfg = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg, 31)
    key = jax.random.key(3)
    ecfg = EvalConfig(num_games=G, rollouts=R, max_moves=max_moves)
    monkeypatch.setenv("ALPHATPU_NO_PACK", "1")

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jtally = jax_eval._vs_random_half(
        jgame, apply_inference, {k: jnp.asarray(v) for k, v in flat.items()},
        key, jax_broadcast_initial(jgame, G),
        jax_eval.EvalConfig(*ecfg), net_first)
    jtally = [int(x) for x in jtally]
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")

    T = max_moves or game.max_game_length
    D = min(game.max_game_length, R)
    tally = _vs_random_half(game, params_from_jax(flat, cfg), None,
                            game.initial(G), ecfg, net_first,
                            uniforms=duel_uniforms(key, T, R, D, G))
    assert [int(x) for x in tally] == jtally
    assert sum(jtally) == G
    assert (jtally[3] > 0) == (max_moves is not None)


def test_eval_vs_random_counts_unfinished_games_as_draws():
    """Both halves through one generator; a 3-ply bound ends no game, and
    every game is a draw."""
    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game, width=16, depth=1), 0)
    cfg = EvalConfig(num_games=8, rollouts=4, max_moves=3)
    assert eval_vs_random(game, net, torch.Generator().manual_seed(0), cfg,
                          device="cpu") == (0, 8, 0)

    full = cfg._replace(max_moves=None)
    got = eval_vs_random(game, net, torch.Generator().manual_seed(1), full,
                         device="cpu")
    gen = torch.Generator().manual_seed(1)
    half = full._replace(num_games=4)
    first = [int(x) for x in _vs_random_half(
        game, net, gen, game.initial(4), half, True)]
    second = [int(x) for x in _vs_random_half(
        game, net, gen, game.initial(4), half, False)]
    assert got == (first[0] + second[0],
                   first[1] + second[1] + first[3] + second[3],
                   first[2] + second[2])
    assert sum(got) == 8


def test_ladder_returns_the_duel_tallies():
    """Three checkpoints, round robin: each pair's tally is the one
    duel_network gives on the same generator stream (unfinished games left
    out, as the duel leaves them)."""
    game = make_game("tictactoe")
    cfg_net = config_for_game(game, width=16, depth=1)
    nets = [(f"net{i}", MLP.from_seed(cfg_net, i)) for i in range(3)]
    dcfg = DuelConfig(num_games=8, rollouts=4)
    got = ladder(game, nets, torch.Generator().manual_seed(5), dcfg,
                 device="cpu")
    gen = torch.Generator().manual_seed(5)
    want = []
    for i, (na, a) in enumerate(nets):
        for nb, b in nets[i + 1:]:
            w, d, l, u = duel_network(game, a, b, gen, dcfg, "cpu")
            assert u == 0
            want.append((na, nb, w, d, l))
    assert got == want
    assert [(a, b) for a, b, *_ in got] == [("net0", "net1"),
                                            ("net0", "net2"),
                                            ("net1", "net2")]
    assert all(sum(t[2:]) == 8 for t in got)


def test_eval_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game, width=16, depth=1), 0)
    assert resolve_device("cpu") == torch.device("cpu")
    for device in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_vs_random(game, net, None, EvalConfig(num_games=2, rollouts=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ladder(game, [("a", net), ("b", net)], None)
