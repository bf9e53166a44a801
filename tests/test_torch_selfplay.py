"""The port's continuous selfplay and replay buffer against the reference.

``alphatpu.selfplay.selfplay_continuous`` runs its kernel path (the
Pallas kernels in the interpreter, ``ALPHATPU_FORCE_INTERPRET=1`` - without
it the CPU takes the unquantized f32 engine whatever the switches ask),
under the same engine switches (``ALPHATPU_PACK``, ``ALPHATPU_NO_PACK``)
as the port.
The test recreates the reference's key stream with ``jax.random`` (per
round: split the carry key, split into search and move keys, one key per
rollout) and feeds the same uniforms to the port through
:class:`~alphatpu_torch.selfplay.SelfplayUniforms`.  Both nets get the same
{-1/8, 0, 1/8} weights (exact float32 products, see test_torch_search).

Tolerances: stats, buffer rows and the carry exactly, except policy values
(rtol 1e-5: softmax rounding and the Newton sum order).  A lane may diverge
only through a CDF prefix-sum tie: at most 1 lane in 128, named with the
carry field that shows it.
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.buffer import create_buffer as jax_create_buffer
from alphatpu.buffer import write_samples as jax_write_samples
from alphatpu.games import make_game as jax_make_game
from alphatpu.nets import apply_inference
from alphatpu.selfplay import SelfplayConfig as JaxSelfplayConfig
from alphatpu.selfplay import selfplay_continuous as jax_selfplay_continuous
from alphatpu_torch.buffer import buffer_size, create_buffer, write_samples
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import config_for_game, params_from_jax
from alphatpu_torch.selfplay import (
    SelfplayConfig, SelfplayUniforms, make_carry, selfplay_continuous,
)

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

CPUCT = 1.5


def dyadic_params(cfg, seed):
    """Weights in {-1/8, 0, 1/8} and zero biases (see test_torch_search)."""
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


def reference_uniforms(key, T, R, D, G):
    """The uniforms the reference's selfplay_continuous draws from ``key``
    (selfplay.py:283 -> 114 -> search.py:465-467)."""
    probs, move = [], []
    for _ in range(T):
        key, k_move = jax.random.split(key)
        k_mcts, k_samp = jax.random.split(k_move)
        probs.append(np.stack([np.asarray(jax.random.uniform(k, (D, G)))
                               for k in jax.random.split(k_mcts, R)]))
        move.append(np.asarray(jax.random.uniform(k_samp, (G,))))
    return SelfplayUniforms(torch.from_numpy(np.stack(probs)),
                            torch.from_numpy(np.stack(move)))


def _rows(buf, n):
    """The buffer's first n rows: integer fields and value, then policy."""
    ints = np.concatenate(
        [np.asarray(buf.state[:n], np.float64),
         np.asarray(buf.player[:n], np.float64)[:, None],
         np.asarray(buf.value[:n], np.float64)[:, None],
         np.asarray(buf.fstate[:n], np.float64)], axis=1)
    return ints, np.asarray(buf.policy[:n])


def _selfplay_matches_reference(monkeypatch, T, env=None):
    """Both packages' selfplay_continuous on the same uniforms, under the
    same engine switches ``env``, then every stat, buffer row and carry
    field compared."""
    G, R = 128, 16
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    cfg_net = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg_net, seed=0)
    key = jax.random.key(7)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jbuf, jstats, jcarry = jax.device_get(
        jax.jit(jax_selfplay_continuous, static_argnums=(0, 1, 5))(
            jgame, apply_inference,
            {k: jnp.asarray(v) for k, v in flat.items()},
            jax_create_buffer(jgame, capacity=4096), key,
            JaxSelfplayConfig(num_games=G, rollouts=R, cpuct=CPUCT,
                              continuous=True, rounds=T)))
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")

    D = min(game.max_game_length, R)
    buf, stats, carry = selfplay_continuous(
        game, params_from_jax(flat, cfg_net), create_buffer(game, 4096),
        None, SelfplayConfig(num_games=G, rollouts=R, cpuct=CPUCT, rounds=T),
        uniforms=reference_uniforms(key, T, R, D, G))

    # lanes whose in-flight episode differs have diverged
    bad = {}
    fields = {"count": (carry.count, jcarry.count),
              "enc": (carry.enc, jcarry.enc),
              "player": (carry.player, jcarry.player)}
    for i, (p, j) in enumerate(zip(carry.positions, jcarry.positions)):
        fields[f"positions[{i}]"] = (p, j)
    for name, (p, j) in fields.items():
        p = p.numpy().astype(np.float64).reshape(G, -1)
        j = np.asarray(j).astype(np.float64).reshape(G, -1)
        for g in np.flatnonzero((p != j).any(1)):
            bad.setdefault(int(g), []).append(f"carry.{name}")
    pol_off = ~np.isclose(carry.pol.numpy(), np.asarray(jcarry.pol),
                          rtol=1e-5, atol=1e-6).reshape(G, -1).all(1)
    for g in np.flatnonzero(pol_off):
        bad.setdefault(int(g), []).append("carry.pol")
    if bad:
        print(f"diverged lanes (CDF-tie class): {bad}")
    assert len(bad) <= G // 128, bad

    jstats = {k: float(np.asarray(v)) for k, v in jstats.items()}
    pstats = {k: float(v) for k, v in stats.items()}
    assert pstats.keys() == jstats.keys()
    n, jn = int(buffer_size(buf)), int(jbuf.total[0])
    ints, pol = _rows(buf, n)
    jints, jpol = _rows(jbuf, jn)
    if not bad:
        assert pstats == jstats
        np.testing.assert_array_equal(ints, jints)
        np.testing.assert_allclose(pol, jpol, rtol=1e-5, atol=1e-6)
    else:
        # one diverged lane changes at most its own rows and episodes
        rows_cap = len(bad) * (T + game.max_game_length)
        for k in jstats:
            assert abs(pstats[k] - jstats[k]) <= rows_cap, k
        diff = Counter(map(tuple, ints)) - Counter(map(tuple, jints))
        assert sum(diff.values()) <= rows_cap
    assert pstats["illegal_moves"] == 0 and pstats["games_finished"] > 0


def test_selfplay_continuous_matches_reference(monkeypatch):
    _selfplay_matches_reference(monkeypatch, T=12)


@pytest.mark.parametrize("env", [{"ALPHATPU_PACK": "2"},
                                 {"ALPHATPU_NO_PACK": "1"},
                                 {"ALPHATPU_BF16_STATS": "1"}])
def test_selfplay_engines_match_reference(env, monkeypatch):
    """The same switch picks the same engine in both packages: level 2
    (the 1-plane word), the f32 engine, and bf16 stat planes under the
    f32 family's engine (16 rollouts: stat_dtype_for takes bf16)."""
    _selfplay_matches_reference(monkeypatch, T=8, env=env)


def test_selfplay_invariants():
    """Lane recycling and the back-fill, on the port alone."""
    game = make_game("connect4")
    cfg_net = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg_net, 1), cfg_net)
    G, T = 32, 24
    cfg = SelfplayConfig(num_games=G, rollouts=16, cpuct=CPUCT, rounds=T)
    buf, stats, carry = selfplay_continuous(
        game, net, create_buffer(game, 2048),
        torch.Generator().manual_seed(1), cfg)
    st = {k: int(v) if k != "mean_length" else float(v)
          for k, v in stats.items()}
    assert st["illegal_moves"] == 0
    assert st["wins"] + st["draws"] + st["losses"] == st["games_finished"]
    assert st["games_finished"] >= G // 2
    assert 6 <= st["mean_length"] <= T  # 0-based ply of the last move
    assert st["unfinished"] == 0
    assert st["samples_written"] + st["carried"] == T * G
    assert int(carry.count.sum()) == st["carried"]
    n = int(buffer_size(buf))
    assert n == st["samples_written"]

    state = buf.state[:n].numpy().astype(np.int64)
    policy, player = buf.policy[:n].numpy(), buf.player[:n].numpy()
    value, fstate = buf.value[:n].numpy(), buf.fstate[:n].numpy()
    assert np.all(np.abs(policy.sum(-1) - 1.0) < 0.05)
    # no policy mass on a full column (row 0 of the column occupied)
    top = np.arange(7) * 6
    full = (state[:, top] + state[:, 42 + top]) > 0
    assert not np.any((policy > 1e-6) & full)
    stones = state.sum(-1)
    np.testing.assert_array_equal(player, np.where(stones % 2 == 0, 1, -1))
    assert set(np.unique(value)).issubset({0.0, 0.5, 1.0})
    assert set(np.unique(fstate)).issubset({-1, 1})
    # every written episode starts from the empty board, once
    assert (stones == 0).sum() == st["games_finished"]


def test_chained_calls_equal_one_call():
    """Two 12-round calls threading the carry (whose generator continues
    the stream) write the same sample multiset as one 24-round call, and
    end in the same in-flight state."""
    game = make_game("connect4")
    cfg_net = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg_net, 2), cfg_net)
    G = 8

    def play(rounds_list):
        buf = create_buffer(game, 2048)
        carry = make_carry(game, G, torch.Generator().manual_seed(7))
        tot = {"samples_written": 0, "games_finished": 0}
        for T in rounds_list:
            cfg = SelfplayConfig(num_games=G, rollouts=8, cpuct=CPUCT,
                                 rounds=T)
            buf, stats, carry = selfplay_continuous(
                game, net, buf, torch.Generator().manual_seed(99), cfg, carry)
            assert int(stats["unfinished"]) == 0
            for k in tot:
                tot[k] += int(stats[k])
        return buf, carry, tot

    buf1, carry1, tot1 = play([24])
    buf2, carry2, tot2 = play([12, 12])
    assert tot1 == tot2
    n1, n2 = int(buffer_size(buf1)), int(buffer_size(buf2))
    assert n1 == n2 == tot1["samples_written"] > 0

    def rows(buf, n):
        ints, pol = _rows(buf, n)
        m = np.concatenate([ints, pol.astype(np.float64)], axis=1)
        return m[np.lexsort(m.T)]

    np.testing.assert_array_equal(rows(buf1, n1), rows(buf2, n2))
    np.testing.assert_array_equal(carry1.count.numpy(), carry2.count.numpy())
    for a, b in zip(carry1.positions, carry2.positions):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_write_samples_matches_reference():
    """Masked appends with wraparound, against the reference's ring."""
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    rng = np.random.default_rng(4)
    cap = 64
    jbuf, buf = jax_create_buffer(jgame, cap), create_buffer(game, cap)
    for _ in range(4):
        N = 40
        rows = (rng.integers(0, 2, (N, 84)), rng.random((N, 7), np.float32),
                rng.choice([-1, 1], N), rng.random(N, np.float32),
                rng.choice([-1, 1], (N, 42)), rng.random(N) < 0.7)
        jbuf = jax_write_samples(jbuf, *(jnp.asarray(x) for x in rows))
        buf = write_samples(buf, *(torch.from_numpy(np.asarray(x))
                                   for x in rows))
    for name in ("state", "policy", "player", "value", "fstate", "cursor",
                 "total"):
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      np.asarray(getattr(jbuf, name)),
                                      err_msg=name)
    # more rows than the capacity in one write: the last ``cap`` are kept
    buf = create_buffer(game, 8)
    N = 20
    value = torch.arange(N, dtype=torch.float32)
    buf = write_samples(buf, torch.zeros((N, 84)), torch.zeros((N, 7)),
                        torch.ones(N), value, torch.ones((N, 42)),
                        torch.ones(N, dtype=torch.bool))
    assert int(buf.total[0]) == N and int(buf.cursor[0]) == N % 8
    assert sorted(buf.value.tolist()) == list(range(N - 8, N))
    assert int(buffer_size(buf)) == 8


@pytest.mark.parametrize("G,fresh_root_policy", [(1, False), (5, True)])
def test_selfplay_small_lane_counts(G, fresh_root_policy):
    """Lane counts that fill no kernel block still play and account, with
    either root-policy convention."""
    game = make_game("connect4")
    cfg_net = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg_net, 3), cfg_net)
    cfg = SelfplayConfig(num_games=G, rollouts=8, cpuct=CPUCT, rounds=10,
                         fresh_root_policy=fresh_root_policy)
    buf, stats, carry = selfplay_continuous(
        game, net, create_buffer(game, 256), torch.Generator().manual_seed(0),
        cfg)
    assert int(stats["illegal_moves"]) == 0
    assert int(stats["samples_written"]) + int(stats["carried"]) == 10 * G


@pytest.mark.parametrize("name,G,R", [("tictactoe", 16, 12),
                                      ("reversi6x6", 16, 8)])
def test_selfplay_generation_matches_reference(name, G, R, monkeypatch):
    """One generation in both packages on the same uniforms (the
    reference's key stream is the continuous mode's): every stat and every
    buffer row equal (policies to rtol 1e-5).  reversi6x6 carries the pass
    column.  At 16 lanes (not a multiple of its 128-lane block) the
    reference searches with its f32 engine, so the port is switched to its
    own (``ALPHATPU_NO_PACK=1``)."""
    from alphatpu.selfplay import selfplay_generation as jax_generation
    from alphatpu_torch.selfplay import selfplay_generation

    jgame, game = jax_make_game(name), make_game(name)
    cfg_net = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg_net, seed=4)
    key = jax.random.key(9)
    cap = G * game.max_game_length
    monkeypatch.setenv("ALPHATPU_NO_PACK", "1")

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jbuf, jstats = jax.device_get(
        jax.jit(jax_generation, static_argnums=(0, 1, 5))(
            jgame, apply_inference,
            {k: jnp.asarray(v) for k, v in flat.items()},
            jax_create_buffer(jgame, capacity=cap), key,
            JaxSelfplayConfig(num_games=G, rollouts=R, cpuct=CPUCT)))
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")

    T = game.max_game_length
    D = min(T, R)
    buf, stats = selfplay_generation(
        game, params_from_jax(flat, cfg_net), create_buffer(game, cap), None,
        SelfplayConfig(num_games=G, rollouts=R, cpuct=CPUCT),
        uniforms=reference_uniforms(key, T, R, D, G))

    jstats = {k: float(np.asarray(v)) for k, v in jstats.items()}
    pstats = {k: float(v) for k, v in stats.items()}
    assert pstats == jstats
    n = int(buffer_size(buf))
    assert n == int(jbuf.total[0]) == pstats["samples_written"] > 0
    ints, pol = _rows(buf, n)
    jints, jpol = _rows(jbuf, n)
    np.testing.assert_array_equal(ints, jints)
    np.testing.assert_allclose(pol, jpol, rtol=1e-5, atol=1e-6)
    assert pstats["illegal_moves"] == 0
    assert (pstats["wins"] + pstats["draws"] + pstats["losses"]
            + pstats["unfinished"]) == G


def test_selfplay_generation_invariants():
    """The port alone: games from the start, moves of finished games only,
    the back-fill, and a move bound that leaves games unfinished."""
    from alphatpu_torch.selfplay import selfplay_generation

    game = make_game("tictactoe")
    cfg_net = config_for_game(game, width=32, depth=2)
    net = params_from_jax(dyadic_params(cfg_net, 5), cfg_net)
    G = 16
    cfg = SelfplayConfig(num_games=G, rollouts=8, cpuct=CPUCT)
    buf, stats = selfplay_generation(game, net, create_buffer(game, 512),
                                     torch.Generator().manual_seed(2), cfg)
    st = {k: float(v) for k, v in stats.items()}
    assert st["illegal_moves"] == 0 and st["unfinished"] == 0
    assert st["wins"] + st["draws"] + st["losses"] == G
    n = int(buffer_size(buf))
    assert n == st["samples_written"]
    # mean_length is the 0-based ply of the last move: samples = ply + 1
    assert n == pytest.approx(G * (st["mean_length"] + 1))
    state = buf.state[:n].numpy().astype(np.int64)
    stones = state.sum(-1)
    assert (stones == 0).sum() == G  # each game once from the empty board
    np.testing.assert_array_equal(buf.player[:n].numpy(),
                                  np.where(stones % 2 == 0, 1, -1))
    assert set(np.unique(buf.value[:n].numpy())) <= {0.0, 0.5, 1.0}

    buf, stats = selfplay_generation(
        game, net, create_buffer(game, 512), torch.Generator().manual_seed(2),
        cfg._replace(max_moves=3))
    assert int(stats["unfinished"]) == G
    assert int(stats["samples_written"]) == 0 == int(buffer_size(buf))
    assert float(stats["mean_length"]) == 0.0
