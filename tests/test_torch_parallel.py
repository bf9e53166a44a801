"""The port's data-parallel training against ``alphatpu.parallel``.

A port rank is a gloo process on the CPU, spawned by
``alphatpu_torch.parallel.run_ranks`` with a ``file://`` rendezvous under
the test's ``tmp_path`` and a timeout of its own (a hung rank fails the
test).  The reference runs its sharded executors on a mesh of the first D
of conftest's 8 CPU devices.

Tolerances:
* sharded selfplay, both modes: each rank is fed the uniforms the
  reference's device d draws from ``device_keys(k, mesh)[d]``; its buffer
  rows and carry equal the reference's shard d exactly (policies to rtol
  1e-5) outside CDF-tie lanes (at most 1 in 128: none at 16 lanes), and
  the summed stats are equal.  Both search with the f32 engine (16 lanes
  are no multiple of the reference's 128-lane block),
* the data-parallel update: the ranks draw the reference's indices
  (``fold_in(fold_in(rng, d), i)``); their parameters equal the reference's
  ``sharded_train_fn`` at rtol 2e-5, atol 1e-6 (the reference's own
  tolerance, tests/test_parallel.py:228-230), and every rank holds the
  same parameters bit for bit,
* the sharded duel: the summed tally equals the sum of the ranks' halves
  and the reference's sharded duel on the same uniforms,
* run_generation over two ranks: tests/test_parallel.py:234-270's
  invariants; a resume from a sharded checkpoint continues exactly; a
  sharded checkpoint crosses packages both ways at D=2 bit for bit.
"""
import itertools
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu import checkpoint as jax_ckpt
from alphatpu.buffer import create_buffer as jax_create_buffer
from alphatpu.duel import DuelConfig as JaxDuelConfig
from alphatpu.games import make_game as jax_make_game
from alphatpu.nets import apply_inference as jax_apply_inference
from alphatpu.nets import config_for_game as jax_config_for_game
from alphatpu.nets import init_params
from alphatpu.parallel import (
    device_keys, make_mesh, sharded_duel_fn as jax_sharded_duel_fn,
    sharded_selfplay_fn as jax_sharded_selfplay_fn,
    sharded_train_fn as jax_sharded_train_fn,
)
from alphatpu.pipeline import PipelineConfig as JaxPipelineConfig
from alphatpu.pipeline import init_pipeline as jax_init_pipeline
from alphatpu.pipeline import run_generation as jax_run_generation
from alphatpu.selfplay import SelfplayConfig as JaxSelfplayConfig
from alphatpu.selfplay import make_carry as jax_make_carry
from alphatpu.train import TrainConfig as JaxTrainConfig
from alphatpu.train import make_optimizer
from alphatpu_torch import checkpoint as ckpt
from alphatpu_torch.buffer import ReplayBuffer, create_buffer
from alphatpu_torch.duel import DuelConfig, duel_half
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import (
    PARAM_NAMES, apply_inference, config_for_game, params_from_jax,
    params_to_numpy,
)
from alphatpu_torch.parallel import (
    World, all_gather, all_reduce, psum_stats, rank_generator, run_ranks,
)
from alphatpu_torch.parallel.dryrun import dryrun_multichip
from alphatpu_torch.parallel.sharded import (
    sharded_duel_fn, sharded_selfplay_fn, sharded_train_fn,
)
from alphatpu_torch.pipeline import (
    PipelineConfig, init_pipeline, resume, run_generation,
)
from alphatpu_torch.selfplay import SelfplayConfig, make_carry
from alphatpu_torch.train import TrainConfig, adam_init

from test_parallel import _filled_sharded_buffer
from test_torch_duel import duel_uniforms
from test_torch_selfplay import dyadic_params, reference_uniforms

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120  # seconds a test's ranks may take
CPUCT = 1.5
FIELDS = ("state", "policy", "player", "value", "fstate", "cursor", "total")
_rendezvous = itertools.count()


def ranks(fn, D, tmp_path, *args):
    """``fn(world, *args)`` on D gloo ranks of this host."""
    init = f"file://{tmp_path}/rendezvous{next(_rendezvous)}"
    return run_ranks(fn, D, *args, device="cpu", init_method=init,
                     timeout=TIMEOUT)


def tiny_pipeline(D, **kw):
    """tests/test_parallel.py's sharded pipeline configuration."""
    return dict(dict(
        selfplay=dict(num_games=2 * D, rollouts=8, continuous=True,
                      rounds=12),
        train=dict(batch_size=8 * D), duel=dict(num_games=2 * D, rollouts=8),
        buffer_capacity=128 * D, generations=2, width=32, depth=2,
        devices=D, log=lambda s: None), **kw)


def port_pipeline(world, **kw):
    cfg = tiny_pipeline(world.size, **kw)
    return PipelineConfig(**{
        **cfg, "selfplay": SelfplayConfig(**cfg["selfplay"]),
        "train": TrainConfig(**cfg["train"]),
        "duel": DuelConfig(**cfg["duel"]), "device": str(world.device)})


def jax_pipeline(D, **kw):
    cfg = tiny_pipeline(D, **kw)
    return JaxPipelineConfig(**{
        **cfg, "selfplay": JaxSelfplayConfig(**cfg["selfplay"]),
        "train": JaxTrainConfig(**cfg["train"]),
        "duel": JaxDuelConfig(**cfg["duel"])})


def _numpy(x):
    return {f: getattr(x, f).numpy() for f in FIELDS}


def _carry_numpy(carry):
    out = {f"positions.{f}": x.numpy()
           for f, x in zip(carry.positions._fields, carry.positions)}
    out.update({f: getattr(carry, f).numpy()
                for f in ("count", "enc", "pol", "player")})
    return out


# ---- the world's primitives ----


def _primitives_rank(world):
    torch.set_num_threads(1)
    r = world.rank
    shared = torch.Generator().manual_seed(11)
    own = rank_generator(shared, world)
    stats = {"wins": torch.tensor(r + 1), "draws": torch.tensor(0),
             "losses": torch.tensor(1), "mean_length": torch.tensor(
                 4.0 + r, dtype=torch.float32),
             "illegal_moves": torch.tensor(0)}
    buf = create_buffer(make_game("tictactoe"), 8)
    buf.total[0] = 3 + 5 * r  # shard 1 wrapped past its capacity
    from alphatpu_torch.buffer import global_buffer_size

    return {
        "own": torch.rand((4,), generator=own).tolist(),
        "shared_next": torch.rand((4,), generator=shared).tolist(),
        "stats": {k: v.item() for k, v in psum_stats(stats).items()},
        "reduce": all_reduce(torch.tensor([r, 2 * r + 1])).tolist(),
        "gather": [g.tolist() for g in all_gather(
            torch.tensor([r == 0, r == 1]))],
        "global_size": global_buffer_size(buf),
    }


def test_world_primitives(tmp_path):
    """Distinct rank streams with the shared stream in step, summed and
    weighted stats, the collectives (bool through uint8) and the global
    buffer size over two ranks."""
    a, b = ranks(_primitives_rank, 2, tmp_path)
    assert a["own"] != b["own"]
    assert a["shared_next"] == b["shared_next"]
    for r in (a, b):
        # rank 0 finished 2 games of mean length 4, rank 1 3 of 5
        assert r["stats"] == {"wins": 3, "draws": 0, "losses": 2,
                              "mean_length": pytest.approx(
                                  (2 * 4.0 + 3 * 5.0) / 5, rel=1e-7),
                              "illegal_moves": 0}
        assert r["reduce"] == [1, 4]
        assert r["gather"] == [[True, False], [False, True]]
        assert r["global_size"] == 3 + 8


def _raising_rank(world):
    if world.rank == 1:
        raise KeyError("rank 1's fault")
    return world.rank


def _sleeping_rank(world):
    time.sleep(60)


def test_run_ranks_reports_a_failed_or_hung_rank(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="rank 1's fault"):
        ranks(_raising_rank, 2, tmp_path)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(_sleeping_rank, 2, device="cpu", timeout=2,
                  init_method=f"file://{tmp_path}/sleep")
    assert time.monotonic() - t0 < 30
    # one rank per card: more ranks than visible cards never start
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    with pytest.raises(ValueError, match="--devices 2 requested but only 1"):
        run_ranks(_raising_rank, 2, device="cuda")


def test_launchers_default_to_the_card(monkeypatch):
    """``run_ranks`` and ``dryrun_multichip`` run a card a rank unless the
    caller asks for the CPU: with no card visible they refuse before any
    rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 CUDA device"):
        run_ranks(_raising_rank, 2)
    with pytest.raises(ValueError, match="only 0 CUDA device"):
        dryrun_multichip(2)


# ---- the sharded executors against the reference's ----


def _selfplay_rank(world, flat, continuous, T, uniforms):
    torch.set_num_threads(1)
    game = make_game("tictactoe")
    net = params_from_jax(flat, config_for_game(game, width=32, depth=2))
    G = 16 * world.size
    run = sharded_selfplay_fn(
        game, apply_inference,
        SelfplayConfig(num_games=G, rollouts=8, cpuct=CPUCT,
                       continuous=continuous, rounds=T), world)
    buf = create_buffer(game, 256)
    out = {}
    if continuous:
        buf, stats, carry = run(net, buf, None,
                                make_carry(game, 16, None),
                                uniforms[world.rank])
        out["carry"] = _carry_numpy(carry)
    else:
        buf, stats = run(net, buf, None, uniforms[world.rank])
    out["buffer"] = _numpy(buf)
    out["stats"] = {k: v.item() for k, v in stats.items()}
    return out


@pytest.mark.parametrize("continuous", [False, True])
def test_sharded_selfplay_matches_reference(continuous, tmp_path,
                                            monkeypatch):
    D, Gd, R = 2, 16, 8
    T = 12 if continuous else None
    jgame = jax_make_game("tictactoe")
    flat = dyadic_params(config_for_game(make_game("tictactoe"), width=32,
                                         depth=2), seed=0)
    mesh = make_mesh(D)
    keys = device_keys(jax.random.key(1), mesh)
    run = jax_sharded_selfplay_fn(
        jgame, jax_apply_inference,
        JaxSelfplayConfig(num_games=D * Gd, rollouts=R, cpuct=CPUCT,
                          continuous=continuous, rounds=T), mesh)
    params = {k: jnp.asarray(v) for k, v in flat.items()}
    jbuf = jax_create_buffer(jgame, capacity=256 * D, shards=D)
    if continuous:
        jcarry = jax_make_carry(jgame, D * Gd, jax.random.key(2))._replace(
            rng=keys)
        jbuf, jstats, jcarry = jax.device_get(run(params, jbuf, keys, jcarry))
    else:
        jbuf, jstats = jax.device_get(run(params, jbuf, keys))

    rounds = T or jgame.max_game_length
    depth = min(jgame.max_game_length, R)
    uniforms = [reference_uniforms(keys[d], rounds, R, depth, Gd)
                for d in range(D)]
    monkeypatch.setenv("ALPHATPU_NO_PACK", "1")
    outs = ranks(_selfplay_rank, D, tmp_path, flat, continuous, T, uniforms)

    jstats = {k: float(np.asarray(v)) for k, v in jstats.items()}
    for d, out in enumerate(outs):
        assert out["stats"].keys() == jstats.keys()
        for k, v in jstats.items():
            assert out["stats"][k] == pytest.approx(v, rel=1e-6), k
        n = int(jbuf.total[d])
        assert n > 0 and out["buffer"]["total"][0] == n
        rows = slice(256 * d, 256 * d + n)
        for f in ("state", "player", "value", "fstate"):
            np.testing.assert_array_equal(out["buffer"][f][:n],
                                          np.asarray(getattr(jbuf, f))[rows],
                                          err_msg=f)
        np.testing.assert_allclose(out["buffer"]["policy"][:n],
                                   np.asarray(jbuf.policy)[rows],
                                   rtol=1e-5, atol=1e-6)
        if continuous:
            lanes = slice(Gd * d, Gd * (d + 1))
            want = {f"positions.{f}": np.asarray(x)[lanes] for f, x in zip(
                jcarry.positions._fields, jcarry.positions)}
            want.update({f: np.asarray(getattr(jcarry, f))[lanes]
                         for f in ("count", "enc", "pol", "player")})
            for f, v in want.items():
                got = out["carry"][f]
                if f == "pol":
                    np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-6)
                else:
                    np.testing.assert_array_equal(
                        got.astype(np.int64), v.astype(np.int64), err_msg=f)
    assert sum(int(out["buffer"]["total"][0]) for out in outs) == \
        jstats["samples_written"]


def _train_rank(world, flat, shards, indices, batch):
    torch.set_num_threads(1)
    game = make_game("tictactoe")
    net = params_from_jax(flat, config_for_game(game, width=32, depth=2),
                          trainable=True)
    buf = ReplayBuffer(**{f: torch.from_numpy(v)
                          for f, v in shards[world.rank].items()})
    run = sharded_train_fn(game, TrainConfig(batch_size=batch), world)
    _, loss = run(net, adam_init(net), buf, None,
                  [torch.from_numpy(i) for i in indices[world.rank]])
    return params_to_numpy(net), float(loss)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_train_matches_reference(D, tmp_path):
    """Global batch 64 over D ranks from shards of 128 rows: 256 // 64 - 1
    = 3 updates at D = 2, 7 at D = 4."""
    jgame = jax_make_game("tictactoe")
    per, batch = 128, 64
    cfg = JaxTrainConfig(batch_size=batch)
    params = init_params(jax.random.key(0),
                         jax_config_for_game(jgame, width=32, depth=2))
    optimizer = make_optimizer(cfg)
    buf = _filled_sharded_buffer(jgame, per, D)
    rng = jax.random.key(7)
    mesh = make_mesh(D)
    ref_params, _, ref_loss = jax_sharded_train_fn(
        jgame, cfg, optimizer, mesh)(params, optimizer.init(params), buf,
                                     rng)

    n_updates = max(per * D // batch - 1, 1)
    indices = [[np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.fold_in(rng, d), i),
        (batch // D,), 0, per)) for i in range(n_updates)] for d in range(D)]
    shards = []
    for d in range(D):
        rows = slice(d * per, (d + 1) * per)
        shard = {f: np.asarray(getattr(buf, f))[rows]
                 for f in FIELDS[:5]}
        shard.update(cursor=np.zeros(1, np.int32),
                     total=np.full(1, per, np.int32))
        shards.append(shard)
    flat = {k: np.asarray(v) for k, v in params.items()}
    outs = ranks(_train_rank, D, tmp_path, flat, shards, indices, batch)
    for name in PARAM_NAMES:
        for d, (got, _) in enumerate(outs):
            np.testing.assert_allclose(got[name],
                                       np.asarray(ref_params[name]),
                                       rtol=2e-5, atol=1e-6,
                                       err_msg=f"rank {d}: {name}")
            np.testing.assert_array_equal(got[name], outs[0][0][name])
    for _, loss in outs:
        assert loss == outs[0][1]
        assert loss == pytest.approx(float(ref_loss), rel=1e-5)


def _duel_rank(world, first, second, uniforms, num_games):
    torch.set_num_threads(1)
    game = make_game("tictactoe")
    cfg_net = config_for_game(game, width=32, depth=2)
    nets = params_from_jax(first, cfg_net), params_from_jax(second, cfg_net)
    cfg = DuelConfig(num_games=num_games, rollouts=8)
    tally = sharded_duel_fn(game, apply_inference, cfg, world)(
        *nets, None, uniforms[world.rank])
    half = duel_half(game, *(lambda x, n=n: apply_inference(n, x)
                             for n in nets), None,
                     cfg._replace(num_games=num_games // world.size),
                     uniforms=uniforms[world.rank])
    return [int(x) for x in tally], [int(x) for x in half]


def test_sharded_duel_sums_the_rank_halves(tmp_path, monkeypatch):
    D, G, R = 2, 16, 8
    jgame, game = jax_make_game("tictactoe"), make_game("tictactoe")
    cfg_net = config_for_game(game, width=32, depth=2)
    first, second = dyadic_params(cfg_net, 11), dyadic_params(cfg_net, 12)
    mesh = make_mesh(D)
    keys = device_keys(jax.random.key(5), mesh)
    ref = jax_sharded_duel_fn(
        jgame, jax_apply_inference, JaxDuelConfig(num_games=G, rollouts=R),
        mesh)({k: jnp.asarray(v) for k, v in first.items()},
              {k: jnp.asarray(v) for k, v in second.items()}, keys)
    T, depth = jgame.max_game_length, min(jgame.max_game_length, R)
    uniforms = [duel_uniforms(keys[d], T, R, depth, G // D) for d in range(D)]
    monkeypatch.setenv("ALPHATPU_NO_PACK", "1")
    outs = ranks(_duel_rank, D, tmp_path, first, second, uniforms, G)
    halves = np.array([half for _, half in outs])
    for tally, _ in outs:
        assert tally == halves.sum(0).tolist()
        assert tally == [int(x) for x in ref]
    assert sum(outs[0][0]) == G


# ---- the pipeline over two ranks ----


def _generation_rank(world):
    torch.set_num_threads(1)
    game = make_game("tictactoe")
    cfg = port_pipeline(world)
    state = init_pipeline(game, cfg)
    out = {"capacity": state.buffer.capacity}
    p0 = state.train_net.base.detach().clone()
    state, out["stats1"] = run_generation(game, state, cfg)
    out["changed"] = not torch.allclose(p0, state.train_net.base)
    out["total"] = int(state.buffer.total[0])
    state, out["stats2"] = run_generation(game, state, cfg)
    out["params"] = params_to_numpy(state.train_net)
    return out


def test_run_generation_over_two_ranks(tmp_path):
    """tests/test_parallel.py::test_production_pipeline_sharded_generation
    on two gloo ranks: two generations of run_generation with devices=2."""
    D = 2
    outs = ranks(_generation_rank, D, tmp_path)
    for out in outs:
        assert out["capacity"] == 128  # this rank's shard
        s1, s2 = out["stats1"], out["stats2"]
        assert s1["illegal_moves"] == 0
        assert s1["games_finished"] >= 2 * D
        assert np.isfinite(s1["loss"])
        assert out["changed"]
        assert out["total"] > 0  # every rank's shard received samples
        assert s2["generation"] == 2
        w, d, l = s2["duel"]
        assert w + d + l + s2["duel_unfinished"] == 2 * D
        assert s1 | {"selfplay_s": 0, "train_s": 0, "duel_s": 0} == \
            outs[0]["stats1"] | {"selfplay_s": 0, "train_s": 0, "duel_s": 0}
        for name in PARAM_NAMES:
            np.testing.assert_array_equal(out["params"][name],
                                          outs[0]["params"][name])


def _resume_rank(world, ckpt_dir):
    torch.set_num_threads(1)
    game = make_game("tictactoe")
    cfg = port_pipeline(world, ckpt_dir=ckpt_dir, save_buffer=True)
    cfg.selfplay = cfg.selfplay._replace(rounds=5)
    state = init_pipeline(game, cfg)
    state, _ = run_generation(game, state, cfg)
    out = {"count": int(state.sp_carry.count.sum())}

    resumed = init_pipeline(game, cfg)
    manifest = resume(game, resumed, cfg)
    out["has_carry"] = manifest["has_carry"]
    out["carry_equal"] = all(
        np.array_equal(a, b) for a, b in zip(
            _carry_numpy(resumed.sp_carry).values(),
            _carry_numpy(state.sp_carry).values()))
    out["buffer_equal"] = all(
        np.array_equal(a, b) for a, b in zip(
            _numpy(resumed.buffer).values(), _numpy(state.buffer).values()))
    state, s_live = run_generation(game, state, cfg)
    resumed, s_res = run_generation(game, resumed, cfg)
    keys = ("samples_written", "carried", "wins", "draws", "losses",
            "games_finished", "unfinished", "loss", "duel", "elo",
            "generation")
    out["stats"] = [{k: s[k] for k in keys} for s in (s_live, s_res)]
    out["buffers"] = [_numpy(state.buffer), _numpy(resumed.buffer)]
    return out


def test_sharded_carry_resume_exact(tmp_path):
    """tests/test_parallel.py::test_sharded_carry_resume_exact on two
    ranks: 5 rounds leave lanes mid-episode; the checkpoint (gathered,
    written by rank 0) gives each rank its carry and buffer shard back
    exactly, and the next generation from it equals the live one."""
    outs = ranks(_resume_rank, 2, tmp_path, str(tmp_path / "ck"))
    assert sum(out["count"] for out in outs) > 0
    for out in outs:
        assert out["has_carry"] and out["carry_equal"]
        assert out["buffer_equal"]
        live, res = out["stats"]
        assert live == res
        for f in FIELDS:
            np.testing.assert_array_equal(out["buffers"][0][f],
                                          out["buffers"][1][f], err_msg=f)


def _checkpoint_rank(world, ckpt_dir):
    torch.set_num_threads(1)
    game = make_game("tictactoe")
    cfg = port_pipeline(world, ckpt_dir=ckpt_dir, save_buffer=True,
                        generations=1)
    cfg.selfplay = cfg.selfplay._replace(rounds=5)
    state = init_pipeline(game, cfg)
    state, _ = run_generation(game, state, cfg)
    return {"buffer": _numpy(state.buffer),
            "carry": _carry_numpy(state.sp_carry),
            "best": params_to_numpy(state.best_net),
            "train": params_to_numpy(state.train_net)}


def test_port_sharded_checkpoint_loads_in_the_reference(tmp_path):
    """Two port ranks write a checkpoint; the reference loads it with its
    D=2 templates: every shard of the buffer and the carry's leaves (not
    its rng) bit for bit, and the nets."""
    D = 2
    ck = tmp_path / "ck"
    outs = ranks(_checkpoint_rank, D, tmp_path, str(ck))
    jgame = jax_make_game("tictactoe")
    tmpl = init_params(jax.random.key(0),
                       jax_config_for_game(jgame, width=32, depth=2))
    carry = jax_make_carry(jgame, 2 * D, jax.random.key(0))
    kd = jax.random.key_data(carry.rng)
    manifest, loaded = jax_ckpt.load_checkpoint(
        str(ck), best_params=tmpl, train_params=tmpl,
        opt_state=make_optimizer(JaxTrainConfig()).init(tmpl),
        rng=jax.random.key_data(jax.random.key(0)),
        buffer=jax_create_buffer(jgame, 128 * D, shards=D),
        sp_carry=carry._replace(rng=jnp.zeros((D,) + kd.shape, kd.dtype)))
    assert manifest["has_buffer"] and manifest["has_carry"]
    jbuf, jcarry = loaded["buffer"], loaded["sp_carry"]
    assert jbuf.cursor.shape == jbuf.total.shape == (D,)
    for d, out in enumerate(outs):
        for f in FIELDS[:5]:
            np.testing.assert_array_equal(
                np.asarray(getattr(jbuf, f))[128 * d:128 * (d + 1)],
                out["buffer"][f], err_msg=f)
        assert int(jbuf.cursor[d]) == out["buffer"]["cursor"][0]
        assert int(jbuf.total[d]) == out["buffer"]["total"][0]
        lanes = slice(2 * d, 2 * (d + 1))
        for f, x in zip(jcarry.positions._fields, jcarry.positions):
            np.testing.assert_array_equal(
                np.asarray(x)[lanes].astype(np.int64),
                out["carry"][f"positions.{f}"].astype(np.int64))
        for f in ("count", "enc", "pol", "player"):
            np.testing.assert_array_equal(np.asarray(getattr(jcarry, f))[
                lanes], out["carry"][f], err_msg=f)
        for name in PARAM_NAMES:
            np.testing.assert_array_equal(np.asarray(loaded["best"][name]),
                                          out["best"][name])
            np.testing.assert_array_equal(np.asarray(loaded["train"][name]),
                                          out["train"][name])


def test_reference_sharded_checkpoint_loads_in_the_port(tmp_path):
    """The reference's run_generation over a 2-device mesh writes a
    checkpoint; each port rank's shard of it (loaded with ``world``) is
    the reference's shard bit for bit, and a resume with another number of
    ranks raises."""
    D = 2
    jgame, game = jax_make_game("tictactoe"), make_game("tictactoe")
    cfg = jax_pipeline(D, ckpt_dir=str(tmp_path), save_buffer=True,
                       generations=1)
    cfg.selfplay = cfg.selfplay._replace(rounds=5)
    state = jax_init_pipeline(jgame, cfg)
    state, _ = jax_run_generation(jgame, state, cfg)
    assert int(np.asarray(state.sp_carry.count).sum()) > 0
    net = params_from_jax({k: np.asarray(v)
                           for k, v in state.best_params.items()},
                          config_for_game(game, width=32, depth=2))
    templates = dict(best_net=net, train_net=net.copy(trainable=True),
                     opt_state=adam_init(net))
    for d in range(D):
        manifest, loaded = ckpt.load_checkpoint(
            str(tmp_path), **templates, buffer=create_buffer(game, 128),
            sp_carry=make_carry(game, 2, None), world=World(d, D, "cpu"))
        rows = slice(128 * d, 128 * (d + 1))
        for f in FIELDS[:5]:
            np.testing.assert_array_equal(
                getattr(loaded["buffer"], f).numpy(),
                np.asarray(getattr(state.buffer, f))[rows], err_msg=f)
        assert loaded["buffer"].total.tolist() == [int(state.buffer.total[d])]
        assert loaded["buffer"].cursor.tolist() == [
            int(state.buffer.cursor[d])]
        lanes = slice(2 * d, 2 * (d + 1))
        got = _carry_numpy(loaded["sp_carry"])
        for f, x in zip(state.sp_carry.positions._fields,
                        state.sp_carry.positions):
            np.testing.assert_array_equal(
                got[f"positions.{f}"], np.asarray(x)[lanes].astype(
                    got[f"positions.{f}"].dtype))
        for f in ("count", "enc", "pol", "player"):
            np.testing.assert_array_equal(
                got[f], np.asarray(getattr(state.sp_carry, f))[lanes],
                err_msg=f)
        assert loaded["sp_carry"].rng is None  # a JAX key crosses no package
    for world, capacity in ((None, 256), (World(0, 4, "cpu"), 64)):
        with pytest.raises(ValueError, match="2 shard"):
            ckpt.load_checkpoint(str(tmp_path), **templates,
                                 buffer=create_buffer(game, capacity),
                                 world=world)


# ---- the entry points ----


def _cli(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "alphatpu_torch.cli", "--device", "cpu",
         "--game", "tictactoe", "--rollout", "8", "--generation", "1",
         "--width", "32", "--depth", "2", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO)


def _communicate(procs):
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the CLI did not finish in {TIMEOUT} s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    return outs


def test_cli_devices_trains_over_two_cpu_ranks(tmp_path):
    """``--devices 2 --device cpu``: two gloo ranks train one generation;
    rank 0 alone writes the stats file and the checkpoint, whose buffer
    has the reference's two-shard layout."""
    ck = tmp_path / "ck"
    (out,) = _communicate([_cli([
        "--samples", "8", "--batchsize", "8", "--duel-games", "8",
        "--duel-rollouts", "4", "--continuous", "--rounds", "8",
        "--buffer-capacity", "512", "--devices", "2", "--save-buffer",
        "--ckpt-dir", str(ck), "--stats-file", str(tmp_path / "s.jsonl")])])
    assert out.count("(dp mesh over 2)") == 2
    assert "done: 1 generations" in out
    assert out.count("[gen 1] duel:") == 1
    assert len((tmp_path / "s.jsonl").read_text().splitlines()) == 1
    assert sorted(os.listdir(ck)) == ["buffer.npz", "carry.npz",
                                      "latest.json", "net1.npz"]
    with np.load(ck / "buffer.npz") as z:
        assert z[".cursor"].shape == (2,) and z[".state"].shape[0] == 512


def test_two_process_multihost_generation():
    """tests/test_multihost.py for the port: two OS processes join one
    world at a localhost coordinator (``--multihost``) and run a
    production generation through the CLI."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    common = ["--samples", "8", "--batchsize", "8", "--duel-games", "8",
              "--duel-rollouts", "4", "--continuous", "--rounds", "8",
              "--devices", "0", "--multihost", "--coordinator",
              f"localhost:{port}", "--num-processes", "2", "--no-checkpoint"]
    outs = _communicate([_cli(common + ["--process-id", str(i)])
                         for i in range(2)])
    for out in outs:
        assert "(dp mesh over 2)" in out
        assert "done: 1 generations" in out
    assert "PROMOTED" in outs[0] or "kept" in outs[0]


def test_dryrun_multichip_on_two_cpu_ranks():
    stats = dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    assert stats["illegal_moves"] == 0 and stats["games_finished"] >= 4
