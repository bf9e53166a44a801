"""The port's probe engines and ``eval_vs_probe`` against ``alphatpu.probe``.

The engines are copies: each one's ``best_action`` must equal the
original's on the same random positions (played through the reference's
rule oracles) and the same ``np.random.default_rng`` seeds.

``eval_vs_probe`` runs in both packages on the same uniforms: the test
recreates the reference's key stream (per ply: split the key, the search
draws one uniform block per rollout from the ply's key, the sampled pick
one uniform per game from ``fold_in(key, 1)``) and feeds it to the port.
The net's weights are in {-1/8, 0, 1/8} (exact float32 products, see
test_torch_search); both packages search with the f32 engine (16 lanes are
no multiple of the reference's 128-lane block).  W/D/L and every ply's
applied action, greedy and sampled pick must be equal.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu import checkpoint as jax_ckpt
from alphatpu import probe as jax_probe
from alphatpu.games import make_game as jax_make_game
from alphatpu.nets import apply_inference
from alphatpu.oracles import (
    OracleConnect4, OracleGobang, OracleHex, OracleReversi,
)
from alphatpu_torch import probe
from alphatpu_torch.checkpoint import save_checkpoint
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import MLP, config_for_game, params_from_jax
from alphatpu_torch.selfplay import SelfplayUniforms
from alphatpu_torch.train import adam_init

from test_torch_selfplay import dyadic_params

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

# engine name -> (oracle, (port engine, reference engine), plies of the
# random playouts: the probes' positions)
ENGINES = {
    "tictactoe": (lambda: OracleGobang(3, 3),
                  lambda m: m.LineProbe(3, 3, 3, depth=9), 8),
    "connect4": (OracleConnect4,
                 lambda m: m.LineProbe(6, 7, 4, depth=4, gravity=True), 30),
    "gobang8": (lambda: OracleGobang(8, 5),
                lambda m: m.GomokuProbe(8, 8, 5, depth=3), 20),
    # the record's 13x13 board at a shallower depth than its probe's 5
    "gobang13": (lambda: OracleGobang(13, 5),
                 lambda m: m.GomokuProbe(13, 13, 5, depth=3), 30),
    "reversi6x6": (lambda: OracleReversi(6),
                   lambda m: m.ReversiProbe(6, depth=4), 20),
    "hex7": (lambda: OracleHex(7), lambda m: m.HexProbe(7, depth=2), 30),
}


def random_positions(oracle, plies, seed, n=6):
    """``n`` positions, each after a random number (below ``plies``) of
    uniform legal moves from the start; none is over."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        st = oracle.initial()
        for _ in range(int(rng.integers(0, plies))):
            legal = oracle.legal_actions(st)
            nxt = oracle.play(st, legal[rng.integers(len(legal))])
            if oracle.is_over(nxt)[0]:
                break
            st = nxt
        out.append(st)
    return out


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_best_action_matches_reference(name):
    make_oracle, make_engine, plies = ENGINES[name]
    oracle = make_oracle()
    ours, ref = make_engine(probe), make_engine(jax_probe)
    for i, st in enumerate(random_positions(oracle, plies, seed=len(name))):
        mover, other = oracle.planes(st)
        for seed in (i, 100 + i):
            got = ours.best_action(mover > 0, other > 0,
                                   np.random.default_rng(seed))
            want = ref.best_action(mover > 0, other > 0,
                                   np.random.default_rng(seed))
            assert got == want, (name, i, seed)
            assert got in oracle.legal_actions(st)


def _fields(engine):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(engine).items()}


@pytest.mark.parametrize("name", ["tictactoe", "connect4", "gobang8",
                                  "gobang9", "gobang13", "reversi6x6",
                                  "reversi8x8", "hex7", "hex13"])
def test_probe_for_game_matches_reference(name):
    """The port's games carry the attributes ``probe_for_game`` reads, so it
    builds the reference's engine for each; an explicit depth is kept."""
    for depth in (None, 2):
        ours = probe.probe_for_game(make_game(name), depth)
        ref = jax_probe.probe_for_game(jax_make_game(name), depth)
        assert type(ours).__name__ == type(ref).__name__
        assert _fields(ours) == _fields(ref)


def probe_uniforms(key, T, R, D, G):
    """The uniforms the reference's eval_vs_probe draws from ``key``
    (probe.py:612 -> search.py:465-467, and probe.py:587-588)."""
    probs, move = [], []
    for _ in range(T):
        key, k = jax.random.split(key)
        probs.append(np.stack([np.asarray(jax.random.uniform(kk, (D, G)))
                               for kk in jax.random.split(k, R)]))
        move.append(np.asarray(jax.random.uniform(jax.random.fold_in(k, 1),
                                                  (G,))))
    return SelfplayUniforms(torch.from_numpy(np.stack(probs)),
                            torch.from_numpy(np.stack(move)))


@pytest.mark.parametrize("temp_moves,depth,seed", [(8, None, 0), (2, 2, 3)])
def test_eval_vs_probe_matches_reference(temp_moves, depth, seed,
                                         monkeypatch):
    """tictactoe, 16 games, 8 rollouts, against the perfect player (depth
    9) and a depth-2 probe."""
    G, R = 16, 8
    jgame, game = jax_make_game("tictactoe"), make_game("tictactoe")
    cfg = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg, 21)
    key = jax.random.key(9)
    monkeypatch.setenv("ALPHATPU_NO_PACK", "1")

    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    jw, jd, jl, jtrace = jax_probe.eval_vs_probe(
        jgame, apply_inference, {k: jnp.asarray(v) for k, v in flat.items()},
        key, jax_probe.probe_for_game(jgame, depth), num_games=G,
        rollouts=R, temp_moves=temp_moves, seed=seed, trace=True)
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")

    T = game.max_game_length
    w, d, l, trace = probe.eval_vs_probe(
        game, params_from_jax(flat, cfg), None,
        probe.probe_for_game(game, depth), num_games=G, rollouts=R,
        temp_moves=temp_moves, seed=seed, trace=True, device="cpu",
        uniforms=probe_uniforms(key, T, R, min(T, R), G))
    assert (w, d, l) == (jw, jd, jl)
    assert w + d + l == G
    assert len(trace["records"]) == len(jtrace["records"])
    for ours, ref in zip(trace["records"], jtrace["records"]):
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in ("result", "net_first", "net_sign"):
        np.testing.assert_array_equal(trace[k], jtrace[k], err_msg=k)


def test_eval_vs_probe_counts_unfinished_games_as_draws():
    """A game still running after max_game_length plies is a draw: a
    tictactoe whose move bound is 4 plies ends no game."""
    game = make_game("tictactoe")
    game.max_game_length = 4
    net = MLP.from_seed(config_for_game(game, width=16, depth=1), 0)
    w, d, l, trace = probe.eval_vs_probe(
        game, net, torch.Generator().manual_seed(0), num_games=4,
        rollouts=4, trace=True, device="cpu")
    assert (w, d, l) == (0, 4, 0)
    assert len(trace["records"]) == 4


def test_eval_vs_probe_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game, width=16, depth=1), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.eval_vs_probe(game, net, None, num_games=2, rollouts=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--game", "tictactoe", "--ckpt", "unused.npz"])


def test_probe_moves_times_every_probe_move(tmp_path):
    """``benchmarks.probe_moves`` times each of the probe's moves and
    leaves the games as ``eval_vs_probe`` plays them: the same tally, and
    one timed move for each probe ply of a live game."""
    from alphatpu_torch.benchmarks import probe_moves

    out = probe_moves.main([
        "--game", "tictactoe", "--games", "4", "--rollout", "4",
        "--depth", "2", "--device", "cpu",
        "--out", str(tmp_path / "moves.json")])
    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game), 0)
    w, d, l, trace = probe.eval_vs_probe(
        game, net, torch.Generator().manual_seed(0),
        probe.probe_for_game(game, 2), num_games=4, rollouts=4,
        trace=True, device="cpu")
    assert (out["net_wins"], out["draws"], out["net_losses"]) == (w, d, l)
    plies = sum(int((r["alive"] & ~r["net_turn"]).sum())
                for r in trace["records"])
    assert out["probe_moves"] == len(out["moves"]) == plies
    assert out["projected_probe_seconds"] == pytest.approx(
        probe_moves.PROJECT_GAMES * plies / 4
        * out["seconds_a_move"]["mean"])
    with open(tmp_path / "moves.json") as f:
        assert json.loads(f.read()) == out


def test_probe_main_reads_either_packages_checkpoint(tmp_path, capsys):
    """``python -m alphatpu_torch.probe`` on the same weights written by the
    port's save_checkpoint and by alphatpu.checkpoint: the same JSON line,
    whose tally covers every game."""
    game = make_game("tictactoe")
    cfg = config_for_game(game)  # the reference size the probe loads
    best = MLP.from_seed(cfg, 4)
    train = best.copy(trainable=True)
    port_path = save_checkpoint(
        str(tmp_path / "port"), 3, best_net=best, train_net=train,
        opt_state=adam_init(train), elo=0.0, best_generation=3,
        rng=torch.Generator().manual_seed(0))
    params = {n: jnp.asarray(getattr(best, n).detach().numpy())
              for n in ("base", "res", "policy_w", "policy_b", "value_w",
                        "value_b", "feature_w", "feature_b")}
    jax_path = jax_ckpt.save_checkpoint(
        str(tmp_path / "jax"), 3, best_params=params, train_params=params,
        opt_state=None, elo=0.0, best_generation=3,
        rng=jax.random.key_data(jax.random.key(0)))
    lines = []
    for path in (port_path, jax_path):
        probe.main(["--game", "tictactoe", "--ckpt", path, "--games", "4",
                    "--rollout", "8", "--depth", "3", "--seed", "1",
                    "--device", "cpu"])
        lines.append(capsys.readouterr().out.strip())
    assert lines[0] == lines[1]
    rec = json.loads(lines[0])
    assert rec["game"] == "tictactoe" and rec["probe_depth"] == 3
    assert rec["net_wins"] + rec["draws"] + rec["net_losses"] == 4


def _probe_ckpt(tmp_path, seed=4):
    game = make_game("tictactoe")
    best = MLP.from_seed(config_for_game(game), seed)
    train = best.copy(trainable=True)
    return save_checkpoint(
        str(tmp_path / "ck"), 1, best_net=best, train_net=train,
        opt_state=adam_init(train), elo=0.0, best_generation=1,
        rng=torch.Generator().manual_seed(0))


def _pair_play(path, out, *extra):
    from alphatpu_torch.benchmarks import probe_pair

    return probe_pair.main([
        "play", "--game", "tictactoe", "--ckpt", path, "--games", "6",
        "--rollout", "8", "--depth", "2", "--device", "cpu", "--out",
        str(out), *extra])


def test_probe_pair_plays_the_same_games_from_a_seed(tmp_path):
    """Two CPU runs of ``probe_pair play`` from one seed, the second with
    the probe's moves in two worker processes: the same trace, ply for
    ply, and the tally ``eval_vs_probe`` gives on the same uniforms."""
    from alphatpu_torch.benchmarks import probe_pair

    path = _probe_ckpt(tmp_path)
    a = _pair_play(path, tmp_path / "a.json")
    b = _pair_play(path, tmp_path / "b.json", "--workers", "2")
    assert a["trace"] == b["trace"]
    cmp = probe_pair.main(["compare", str(tmp_path / "a.json"),
                           str(tmp_path / "b.json")])
    assert cmp["identical"] == cmp["same_actions"] == 6
    assert cmp["parting"] == 0 and cmp["wdl"][0] == cmp["wdl"][1]
    game = make_game("tictactoe")
    with np.load(path) as z:
        net = params_from_jax(dict(z), config_for_game(game), prefix="best/")
    draws = probe_pair.PlyDraws(0, 8, 8, 6)
    w, d, l = probe.eval_vs_probe(
        game, net, None, probe.probe_for_game(game, 2), num_games=6,
        rollouts=8, device="cpu", uniforms=draws.uniforms())
    assert [w, d, l] == probe_pair.wdl(a) and w + d + l == 6
    for g in a["trace"]:
        assert len(g["actions"]) == len(g["greedy"]) == len(g["sampled"])
        assert g["outcome"] in probe_pair.OUTCOMES
    # ply t's uniforms come from default_rng([seed, t]) whatever was drawn
    probs, move = draws.draw(3)
    rng = np.random.default_rng([0, 3])
    np.testing.assert_array_equal(probs.numpy(),
                                  rng.random((8, 8, 6), dtype=np.float32))
    np.testing.assert_array_equal(move.numpy(),
                                  rng.random(6, dtype=np.float32))


@pytest.mark.parametrize("key,game,ply", [("sampled", 2, 1),
                                          ("actions", 5, 0),
                                          ("greedy", 0, 3)])
def test_probe_pair_compare_finds_a_planted_difference(tmp_path, key, game,
                                                       ply):
    """One pick changed at one ply of one game: ``compare`` reports that
    game alone, parting at that ply (and its applied actions there only
    where the applied action was the one changed)."""
    import copy

    from alphatpu_torch.benchmarks import probe_pair

    a = _pair_play(_probe_ckpt(tmp_path), tmp_path / "a.json")
    b = copy.deepcopy(a)
    g = b["trace"][game]
    g[key][ply] = (g[key][ply] + 1) % 9
    cmp = probe_pair.compare(a, b)
    assert cmp["parting"] == 1 and cmp["identical"] == 5
    (part,) = cmp["games_parting"]
    assert (part["game"], part["ply"]) == (game, ply)
    assert part["actions_ply"] == (ply if key == "actions" else None)
    assert cmp["same_actions"] == 6 - (key == "actions")
    assert cmp["first_ply_histogram"] == {ply: 1}


def test_probe_pair_rerun_and_classify_on_the_cpu(tmp_path):
    """The attribution's two halves on the CPU: a trace from another net
    parts from the first; ``rerun`` rebuilds each first divergence's ply
    from the first trace and reproduces its picks (the plain versions are
    the CPU's path, so kernel and plain agree), and ``classify`` replays
    the recorded net outputs to the same picks and, with the other net's
    checkpoint, reproduces the other trace's picks: net rounding."""
    from alphatpu_torch.benchmarks import probe_pair

    a = _pair_play(_probe_ckpt(tmp_path / "x", 4), tmp_path / "a.json")
    other = _probe_ckpt(tmp_path / "y", 5)
    b = _pair_play(other, tmp_path / "b.json")
    cmp = probe_pair.compare(a, b)
    assert cmp["parting"] > 0
    rr = probe_pair.main([
        "rerun", "--ckpt", a["ckpt"], "--card", str(tmp_path / "a.json"),
        "--cpu", str(tmp_path / "b.json"), "--device", "cpu", "--out",
        str(tmp_path / "rerun")])
    assert all(all(p["reproduced"]) for p in rr["plies"])
    assert not any(any(p["kernel_vs_plain"]) for p in rr["plies"])
    assert {g for p in rr["plies"] for g in p["games"]} == {
        p["game"] for p in cmp["games_parting"]}
    out = probe_pair.main([
        "classify", "--ckpt", other, "--rerun", str(tmp_path / "rerun"),
        "--cpu", str(tmp_path / "b.json"), "--out",
        str(tmp_path / "classes.json")])
    assert out["classes"] == {"net rounding": len(out["lanes"])}
    assert out["logit_max_abs_diff"] > 0


def test_probe_pair_selfplay_rounds_compare(tmp_path):
    """``probe_pair selfplay``: round r's uniforms from ``default_rng([seed,
    r])``, so two runs from one seed play the same lanes round for round
    (no round parts) and another seed's part at some round."""
    from alphatpu_torch.benchmarks import probe_pair

    path = _probe_ckpt(tmp_path)
    runs = []
    for i, seed in enumerate((0, 0, 1)):
        runs.append(probe_pair.main([
            "selfplay", "--game", "tictactoe", "--ckpt", path, "--games",
            "4", "--rollout", "8", "--rounds", "10", "--seed", str(seed),
            "--device", "cpu", "--out", str(tmp_path / f"sp{i}.json")]))
    a, b, c = runs
    assert a["games_finished"] > 0 and a["illegal_moves"] == 0
    assert len(a["lanes"]) == 10 and len(a["lanes"][0]) == 4
    same = probe_pair.compare(a, b)
    assert same["first_round_parting"] is None
    assert same["mean_length"][0] == same["mean_length"][1]
    other = probe_pair.compare(a, c)
    assert other["first_round_parting"] is not None
    assert other["lanes_parted_by_round"][other["first_round_parting"]] > 0
