"""The port's duel and Elo against ``alphatpu.duel``.

``duel_half`` runs in both packages on the same uniforms: the test
recreates the reference's key stream (per round: split the key into three,
the search draws one uniform block per rollout from the second, the move
sampling one uniform per game from the third) and feeds it to the port.
Both nets get weights in {-1/8, 0, 1/8} (exact float32 products, see
test_torch_search); the tallies must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.duel import DuelConfig as JaxDuelConfig
from alphatpu.duel import duel_half as jax_duel_half
from alphatpu.duel import elo_update as jax_elo_update
from alphatpu.games import make_game as jax_make_game
from alphatpu.nets import apply_inference
from alphatpu_torch.duel import DuelConfig, duel_half, duel_network, elo_update
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import config_for_game, params_from_jax
from alphatpu_torch.selfplay import SelfplayUniforms

from test_torch_selfplay import dyadic_params

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)


def test_duel_config_defaults_match_reference():
    assert tuple(DuelConfig()) == tuple(JaxDuelConfig())
    assert DuelConfig._fields == JaxDuelConfig._fields


@pytest.mark.parametrize("current", [-1000.0, 0.0, 123.5])
def test_elo_update_matches_reference(current):
    grid = [(w, d, l) for w in (0, 1, 5, 512) for d in (0, 1, 7)
            for l in (0, 1, 5, 512)]
    for w, d, l in grid:
        assert elo_update(w, d, l, current) == \
            jax_elo_update(w, d, l, current), (w, d, l)
    assert elo_update(768, 0, 256, 0.0) == pytest.approx(190.8, abs=0.1)
    assert elo_update(0, 0, 0, current) == current - 400.0
    assert elo_update(3, 0, 0, current) == current + 400.0


def duel_uniforms(key, T, R, D, G):
    """The uniforms the reference's duel_half draws from ``key``
    (duel.py:55 -> search.py:465-467)."""
    probs, move = [], []
    for _ in range(T):
        key, k_mcts, k_samp = jax.random.split(key, 3)
        probs.append(np.stack([np.asarray(jax.random.uniform(k, (D, G)))
                               for k in jax.random.split(k_mcts, R)]))
        move.append(np.asarray(jax.random.uniform(k_samp, (G,))))
    return SelfplayUniforms(torch.from_numpy(np.stack(probs)),
                            torch.from_numpy(np.stack(move)))


@pytest.mark.parametrize("temp_moves", [15, 3])
def test_duel_half_matches_reference(temp_moves, monkeypatch):
    """tictactoe, 16 games, 8 rollouts, the two nets alternating by round
    parity: the port's tally equals the reference's.  Both search with the
    f32 engine (16 lanes are no multiple of the reference's 128-lane
    block)."""
    G, R = 16, 8
    jgame, game = jax_make_game("tictactoe"), make_game("tictactoe")
    net_cfg = config_for_game(game, width=32, depth=2)
    first, second = dyadic_params(net_cfg, 11), dyadic_params(net_cfg, 12)
    key = jax.random.key(5)
    jcfg = JaxDuelConfig(num_games=G, rollouts=R, temp_moves=temp_moves)
    monkeypatch.setenv("ALPHATPU_NO_PACK", "1")

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jtally = jax.jit(jax_duel_half, static_argnums=(0, 1, 5))(
        jgame, apply_inference,
        {k: jnp.asarray(v) for k, v in first.items()},
        {k: jnp.asarray(v) for k, v in second.items()}, key, jcfg)
    jtally = [int(x) for x in jtally]
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")

    T = game.max_game_length
    D = min(T, R)
    tally = duel_half(game, params_from_jax(first, net_cfg),
                      params_from_jax(second, net_cfg), None,
                      DuelConfig(num_games=G, rollouts=R,
                                 temp_moves=temp_moves),
                      uniforms=duel_uniforms(key, T, R, D, G))
    assert [int(x) for x in tally] == jtally
    assert sum(jtally) == G and jtally[3] == 0


def test_duel_picks_the_actor_by_round_parity():
    """Round t searches with nets[t % 2]: the first net on even rounds."""
    game = make_game("tictactoe")
    calls = []

    def tagged(tag):
        def net(x):
            calls.append(tag)
            return (torch.zeros((x.shape[0], 9)),
                    torch.full((x.shape[0],), 0.5))
        return net

    R = 4
    duel_half(game, tagged("a"), tagged("b"),
              torch.Generator().manual_seed(0),
              DuelConfig(num_games=4, rollouts=R))
    want = [("a" if t % 2 == 0 else "b") for t in range(9) for _ in range(R)]
    assert calls == want


def test_duel_stronger_net_wins():
    """A net biased toward the centre column beats a uniform net at
    Connect-4 over a small duel (probabilistic, with a wide margin)."""
    game = make_game("connect4")

    def biased(bias):
        def net(x):
            logits = torch.zeros((x.shape[0], 7))
            logits[:, 3] = bias
            return logits, torch.full((x.shape[0],), 0.5)
        return net

    cfg = DuelConfig(num_games=32, rollouts=12)
    w, d, l, u = duel_network(game, biased(2.0), biased(0.0),
                              torch.Generator().manual_seed(0), cfg)
    assert w + d + l + u == 32
    assert u == 0  # connect4 always ends within the move bound
    assert w > l, (w, d, l)


def test_unfinished_games_are_left_out_of_the_tally():
    """A move bound below the game's length: every game is unfinished and
    none is counted a draw."""
    game = make_game("connect4")

    def uniform(x):
        return torch.zeros((x.shape[0], 7)), torch.full((x.shape[0],), 0.5)

    w, d, l, u = duel_network(game, uniform, uniform,
                              torch.Generator().manual_seed(1),
                              DuelConfig(num_games=8, rollouts=4,
                                         max_moves=5))
    assert (w, d, l, u) == (0, 0, 0, 8)
