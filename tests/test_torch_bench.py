"""The port's bench, config matrix and rollout ablation against the root
``bench.py`` and ``benchmarks/``.

On the CPU the bench runs the kernels' plain versions through the same
wrappers (whose launch counters move only on CUDA).  The generation loop
is held to the reference's bench loop (bench.py:115-134) on the same
uniforms: ``alphatpu.selfplay.selfplay_continuous`` on its kernel path
(Pallas in the interpreter, ``ALPHATPU_FORCE_INTERPRET=1``), superblock
keys from ``fold_in``, chunks chained through the carry's key; the port
gets each chunk's draws through ``generation``'s ``uniforms`` and the same
{-1/8, 0, 1/8} weights.  Tolerance: the summed stats exactly (the
allowance of 1 diverged lane in 128, ROADMAP queue 3, is not needed with
these weights and is not granted).
"""
import importlib.util
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.buffer import create_buffer as jax_create_buffer
from alphatpu.games import make_game as jax_make_game
from alphatpu.nets import apply_inference as jax_apply_inference
from alphatpu.selfplay import SelfplayConfig as JaxSelfplayConfig
from alphatpu.selfplay import make_carry as jax_make_carry
from alphatpu.selfplay import selfplay_continuous as jax_selfplay_continuous
from alphatpu_torch import bench
from alphatpu_torch.benchmarks import ablate_rollout, matrix
from alphatpu_torch.buffer import create_buffer
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import (
    MLP, apply_inference, config_for_game, params_from_jax,
)
from alphatpu_torch.selfplay import (
    SelfplayConfig, make_carry, selfplay_continuous,
)
from test_torch_selfplay import dyadic_params, reference_uniforms

REPO = Path(__file__).resolve().parents[1]

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

# the port's result fields that bench.py's lacks (bench.py's main adds
# ``device`` after measure returns)
PORT_FIELDS = {
    "wall_s_all", "spread", "nn_mfu", "peak_flops", "peak", "illegal_moves",
    "rounds_played", "pack_level", "stat_dtype", "launches",
    "launches_owed", "peak_mem_bytes", "device", "captured",
    "graph_replays", "graph_captures", "warmup_graph_captures", "capture_s",
    "graph_nodes", "graph_pool_bytes",
}
SMOKE = dict(games=128, rollouts=8, rounds=12)


def _jax_bench():
    """The root bench module (it imports jax inside ``measure``)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import bench as jax_bench

    return jax_bench


@pytest.fixture(scope="module")
def smoke_result():
    return bench.measure("tictactoe", device="cpu", **SMOKE)


def test_measure_smoke(smoke_result):
    """The counterpart of tests/test_bench.py's smoke: a well-formed result
    with bench.py's keys, less its TPU MFU, plus the port's fields."""
    r = smoke_result
    assert r["unit"] == "env-steps/s"
    assert r["value"] > 0
    assert r["vs_baseline"] is None
    assert r["metric"] == ("torch_selfplay_env_steps_per_s_tictactoe_g128_r8"
                           "_cpu")
    ex = r["extra"]
    assert abs(ex["rollouts_per_s"] - r["value"] * 8) < 8  # rounded fields
    assert ex["params"] > 0 and ex["net"] == "6x128"
    assert 0 < ex["mean_game_length"] <= 9
    assert ex["illegal_moves"] == 0
    assert ex["env_steps"] == ex["samples_written"] + ex["carried"]
    assert len(ex["wall_s_all"]) == bench.REPEATS
    assert ex["spread"] >= 0
    # on the CPU: no kernel launched, no device metric
    assert ex["device"]["type"] == "cpu"
    assert ex["nn_mfu"] is None and ex["peak_mem_bytes"] is None
    assert set(ex["launches"].values()) == {0}
    assert not ex["captured"] and ex["graph_replays"] == 0  # eager rounds
    assert ex["launches_owed"] == bench.owed_launches(
        make_game("tictactoe"), 1, 8, 12, 1)

    ref = _jax_bench().measure("tictactoe", **SMOKE)
    assert r.keys() == ref.keys()
    assert set(ex) == set(ref["extra"]) - {"nn_mfu_vs_bf16_peak"} | PORT_FIELDS
    assert ex["params"] == ref["extra"]["params"]
    assert ex["net"] == ref["extra"]["net"]


def test_measure_chunked_same_counts(smoke_result):
    """Chained chunks play the same games as one call: the same env-steps
    and mean length."""
    chunked = bench.measure("tictactoe", device="cpu", chunk=4, **SMOKE)
    ex, single = chunked["extra"], smoke_result["extra"]
    assert ex["chunk_rounds"] == 4 and ex["rounds_played"] == 12
    assert ex["env_steps"] == single["env_steps"]
    assert ex["samples_written"] == single["samples_written"]
    assert ex["mean_game_length"] == single["mean_game_length"]


def test_measure_superblocks_sum_two_generations():
    """256 lanes in superblocks of 128: the sum of two 128-lane runs, each
    on its own stream."""
    R, T = 8, 6
    r = bench.measure("tictactoe", games=256, rollouts=R, rounds=T,
                      superblock=128, device="cpu")
    ex = r["extra"]
    assert (ex["superblock_lanes"], ex["superblocks"]) == (128, 2)
    assert ex["launches_owed"] == bench.owed_launches(
        make_game("tictactoe"), 1, R, T, 2)

    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game), 0)
    cfg = SelfplayConfig(num_games=128, rollouts=R, cpuct=bench.CPUCT,
                         continuous=True, rounds=T)
    sums = {"samples_written": 0, "carried": 0}
    for s in range(2):
        _, stats, _ = selfplay_continuous(
            game, partial(apply_inference, net), create_buffer(game, 4096),
            None, cfg, make_carry(game, 128,
                                  bench.superblock_generator(2, s, "cpu")))
        for k in sums:
            sums[k] += int(stats[k])
    assert ex["samples_written"] == sums["samples_written"]
    assert ex["carried"] == sums["carried"]
    assert ex["env_steps"] == 256 * T  # every lane decides every round


def test_generation_matches_the_reference_bench_loop(monkeypatch):
    """bench.py's generation loop (2 superblocks x 2 chained chunks) and the
    port's ``generation`` on the same uniforms: the same summed stats."""
    G, R, chunk, n_sb, n_chunks = 128, 16, 4, 2, 2
    jgame, game = jax_make_game("connect4"), make_game("connect4")
    cfg_net = config_for_game(game, width=32, depth=2)
    flat = dyadic_params(cfg_net, seed=6)
    for k in bench.ENGINE_SWITCHES:
        monkeypatch.delenv(k, raising=False)

    # the reference's loop, bench.py:115-134, recording each chunk's key
    monkeypatch.setenv("ALPHATPU_FORCE_INTERPRET", "1")
    run = jax.jit(jax_selfplay_continuous, static_argnums=(0, 1, 5))
    jcfg = JaxSelfplayConfig(num_games=G, rollouts=R, cpuct=bench.CPUCT,
                             continuous=True, rounds=chunk)
    params = {k: jnp.asarray(v) for k, v in flat.items()}
    key = jax.random.key(2)
    b = jax_create_buffer(jgame, capacity=4096)
    keys, totals, carried = [], None, 0
    for s in range(n_sb):
        carry = jax_make_carry(jgame, G, jax.random.fold_in(key, s))
        keys.append([])
        for _ in range(n_chunks):
            keys[s].append(carry.rng)
            b, stats, carry = run(jgame, jax_apply_inference, params, b,
                                  carry.rng, jcfg, carry)
            stats["length_sum"] = stats["mean_length"] * stats[
                "games_finished"]
            sb_carried = stats.pop("carried")
            totals = stats if totals is None else jax.tree.map(
                jnp.add, totals, stats)
        carried = carried + sb_carried
    totals["carried"] = carried
    monkeypatch.delenv("ALPHATPU_FORCE_INTERPRET")
    ref = {k: float(np.asarray(v)) for k, v in jax.device_get(totals).items()}

    D = min(game.max_game_length, R)
    got = bench.generation(
        game, partial(apply_inference, params_from_jax(flat, cfg_net)),
        create_buffer(game, 4096),
        SelfplayConfig(num_games=G, rollouts=R, cpuct=bench.CPUCT,
                       continuous=True, rounds=chunk),
        seed=0, n_sb=n_sb, n_chunks=n_chunks,
        uniforms=lambda s, c: reference_uniforms(keys[s][c], chunk, R, D, G))
    got = {k: float(v) for k, v in got.items()}
    ref.pop("mean_length")  # bench.py keeps it per chunk only
    assert got.keys() == ref.keys()
    for k in ("samples_written", "carried", "games_finished", "wins",
              "draws", "losses", "illegal_moves", "unfinished"):
        assert got[k] == ref[k], k
    assert got["length_sum"] == ref["length_sum"]
    # bench.py's mean_game_length: the summed lengths over the games
    assert (got["length_sum"] / got["games_finished"]
            == ref["length_sum"] / ref["games_finished"])
    assert got["games_finished"] > 0 and got["illegal_moves"] == 0
    assert (got["samples_written"] + got["carried"]
            == n_sb * G * n_chunks * chunk)


@pytest.mark.parametrize("game_name,games,rounds,chunk,superblock,want", [
    # connect4's defaults: 168 rounds, one 8192-lane batch
    ("connect4", 8192, 0, 0, 0, (168, 168, 1, 8192, 1)),
    # the matrix's 32,768-lane row: 4 superblocks, 2 chunks of 84
    ("connect4", 32768, 0, 84, 0, (168, 84, 2, 8192, 4)),
    # BENCH_SUPERBLOCK=-1 forces one lockstep batch
    ("connect4", 32768, 0, 0, -1, (168, 168, 1, 32768, 1)),
    # a lane count that is no multiple of 8192 stays one batch
    ("connect4", 12288, 0, 0, 0, (168, 168, 1, 12288, 1)),
    # the 13x13 boards: 338 rounds by default; 352 in 16-round chunks
    ("hex13", 2048, 0, 0, 0, (338, 338, 1, 2048, 1)),
    ("gobang13", 2048, 352, 16, 0, (352, 16, 22, 2048, 1)),
    # a chunk that does not divide the rounds plays whole chunks
    ("tictactoe", 128, 10, 4, 0, (10, 4, 3, 128, 1)),
])
def test_schedule_follows_bench_py(game_name, games, rounds, chunk,
                                   superblock, want):
    assert bench.schedule(make_game(game_name), games, rounds, chunk,
                          superblock) == want


@pytest.mark.parametrize("level,rounds_played,superblocks", [
    (1, 168, 1), (1, 168, 4), (1, 12, 2), (2, 168, 1), (2, 352, 1),
    (2, 12, 4), (0, 168, 1), (0, 12, 4)])
def test_owed_launches(level, rounds_played, superblocks):
    """A round owes ``rollouts`` walks of its level's kernel and one
    flush, per superblock, and the game's end test once a rollout and once
    for the move (connect4: ``line_is_over``); chunks change nothing.
    Level 0 (f32 planes under ALPHATPU_NO_PACK, every bf16 search) walks
    with select_apply."""
    owed = bench.owed_launches(make_game("connect4"), level, 64,
                               rounds_played, superblocks)
    walk = {0: "select_apply", 1: "select_apply_packed",
            2: "select_apply_packed1"}[level]
    assert owed == {"select_apply_packed": 0, "select_apply_packed1": 0,
                    "select_apply": 0, "select": 0,
                    walk: 64 * rounds_played * superblocks,
                    "backup": rounds_played * superblocks,
                    "reversi_play": 0, "reversi_is_over": 0,
                    "line_is_over": 65 * rounds_played * superblocks,
                    "hex_is_over": 0}


def test_measure_pins_the_engine_and_restores_the_switches(monkeypatch):
    """Level 2 runs under ALPHATPU_PACK=2 whatever the caller set, and the
    caller's switches come back afterwards."""
    from alphatpu_torch.mcts import search

    monkeypatch.setenv("ALPHATPU_NO_PACK", "1")
    monkeypatch.delenv("ALPHATPU_PACK", raising=False)
    seen = []
    real = search.engine_level

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(search, "engine_level", spy)
    r = bench.measure("tictactoe", games=16, rollouts=8, rounds=2,
                      pack_level=2, device="cpu")
    assert set(seen) == {2}
    assert r["metric"].endswith("_l2_cpu")
    assert r["extra"]["launches_owed"]["select_apply_packed1"] == 8 * 2
    assert os.environ["ALPHATPU_NO_PACK"] == "1"
    assert "ALPHATPU_PACK" not in os.environ
    with pytest.raises(ValueError, match="level 0, 1 or 2"):
        bench.measure("tictactoe", games=16, rollouts=8, rounds=2,
                      pack_level=3, device="cpu")


@pytest.mark.parametrize("bf16_stats", [False, True])
def test_measure_level_0_and_bf16_stats(bf16_stats, monkeypatch):
    """``pack_level=0`` runs select_apply on f32 planes under a metric
    ending in ``_l0`` (bench.py under ALPHATPU_NO_PACK=1); under
    ALPHATPU_BF16_STATS the searches store bf16 planes and run level 0
    whatever level is asked, and the metric ends in ``_bf16stats``.  The
    caller's switches come back afterwards."""
    from alphatpu_torch.mcts import search

    monkeypatch.delenv("ALPHATPU_NO_PACK", raising=False)
    monkeypatch.setenv("ALPHATPU_PACK", "2")
    if bf16_stats:
        monkeypatch.setenv("ALPHATPU_BF16_STATS", "1")
    else:
        monkeypatch.delenv("ALPHATPU_BF16_STATS", raising=False)
    seen = set()
    real = search.run_mcts

    def spy(game, net, tree, **kw):
        seen.add((tree.prior.dtype,
                  search.engine_level(kw.get("packed_stats"),
                                      kw.get("segment_rollouts", True),
                                      tree.prior.dtype)))
        return real(game, net, tree, **kw)

    monkeypatch.setattr(search, "run_mcts", spy)
    monkeypatch.setattr("alphatpu_torch.selfplay.run_mcts", spy)
    r = bench.measure("tictactoe", games=16, rollouts=16, rounds=2,
                      pack_level=1 if bf16_stats else 0, device="cpu")
    dtype = torch.bfloat16 if bf16_stats else torch.float32
    assert seen == {(dtype, 0)}
    ex = r["extra"]
    assert ex["pack_level"] == 0
    assert ex["stat_dtype"] == ("bfloat16" if bf16_stats else "float32")
    assert r["metric"] == ("torch_selfplay_env_steps_per_s_tictactoe_g16_r16"
                           + ("_bf16stats" if bf16_stats else "_l0")
                           + "_cpu")
    assert ex["launches_owed"] == bench.owed_launches(
        make_game("tictactoe"), 0, 16, 2, 1)
    assert ex["launches_owed"]["select_apply"] == 16 * 2
    assert os.environ["ALPHATPU_PACK"] == "2"
    assert "ALPHATPU_NO_PACK" not in os.environ


def test_measure_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure("tictactoe", games=16, rollouts=8, rounds=2)


def test_main_prints_one_line_and_fails_without_a_card():
    """``python -m alphatpu_torch.bench``: one JSON line on the CPU when
    asked; without a card it exits nonzero and prints no result."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               BENCH_GAME="tictactoe", BENCH_GAMES="16", BENCH_ROUNDS="2",
               BENCH_ROLLOUTS="8", BENCH_ANCHOR_STEPS_PER_S="100")
    env.pop("BENCH_DEVICE", None)
    cmd = [sys.executable, "-m", "alphatpu_torch.bench"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    out = subprocess.run(cmd, cwd=REPO, env=dict(env, BENCH_DEVICE="cpu"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["anchor"] == "BENCH_ANCHOR_STEPS_PER_S=100"
    assert r["vs_baseline"] == round(r["value"] / 100, 3)


def test_matrix_configs_equal_the_reference():
    spec = importlib.util.spec_from_file_location(
        "jax_matrix", REPO / "benchmarks" / "matrix.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert matrix.CONFIGS == ref.CONFIGS
    assert len(matrix.CONFIGS) == 19
    assert (matrix.LANES, matrix.ROLLOUTS) == (ref.LANES, ref.ROLLOUTS)


def test_matrix_records_a_failing_row_and_goes_on(tmp_path):
    out = tmp_path / "m.json"
    rows = [("nogame", 16, False, 0, 2, 0), ("tictactoe", 16, False, 0, 2, 2)]
    results = matrix.run_rows(rows, out, rollouts=8, device="cpu",
                              log=lambda line: None)
    assert json.loads(out.read_text()) == results
    assert results[0]["metric"] == "nogame_g16"
    assert results[0]["error"].startswith("ValueError: unknown game")
    assert results[1]["metric"].endswith("_g16_r8_l2_cpu")
    assert results[1]["extra"]["pack_level"] == 2


def test_matrix_exits_nonzero_when_a_row_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(matrix, "CONFIGS", [("nogame", 16, False, 0, 2, 0)])
    out = tmp_path / "m.json"
    assert matrix.main([str(out)]) == 1
    assert "error" in json.loads(out.read_text())[0]


@pytest.mark.parametrize("name", list(ablate_rollout.VARIANTS))
def test_ablate_rollout_variants_run(name):
    """Each variant plays a move of 8 rollouts on 16 lanes; what it leaves
    in the tree shows which phases ran."""
    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game, width=32, depth=2), 0)
    positions = game.initial(16)
    from alphatpu_torch.mcts.tree import init_tree

    tree = init_tree(game, positions, 8)
    variant = ablate_rollout.VARIANTS[name]
    ms, counted = ablate_rollout.time_variant(
        game, net, tree, positions, torch.Generator().manual_seed(0), 8,
        variant, moves=1)
    assert ms > 0 and set(counted.values()) == {0}  # plain versions
    visits = tree.visits[:, 0, :].sum(0)
    if variant.select and variant.expand and variant.backup:
        # the first rollout expands the root; the other 7 pass through it
        assert torch.equal(visits, torch.full((16,), 7.0))
    elif variant.backup and not variant.select:
        # a root edge taken at random each rollout, backed up
        assert torch.equal(visits, torch.full((16,), 8.0))
    else:  # nothing backed up, or the root never expanded
        assert int(visits.sum()) == 0
    # a node allocated each rollout past the root's own expansion; every
    # rollout without the walk allocates one
    nodes = (1 if not variant.expand else 8 if variant.select else 9)
    assert torch.equal(tree.next_idx, torch.full((16,), nodes,
                                                 dtype=torch.int32))
    owed = ablate_rollout.owed_launches(game, variant, 8, 1)
    assert (owed["select"], owed["backup"]) == (8 * variant.select,
                                                8 * variant.backup)


def test_ablate_returns_each_variant():
    out = ablate_rollout.ablate("tictactoe", games=16, rollouts=8,
                                names=("full", "select-only"), moves=1,
                                device="cpu", log=lambda line: None)
    assert list(out) == ["full", "select-only"]
    assert all(v["ms_per_move"] > 0 for v in out.values())
