"""The port's checkpoints, pipeline and CLI.

Checkpoints cross-load both ways with ``alphatpu.checkpoint``: the nets,
the optimizer state and the buffer, bit for bit.  The pipeline runs two
tiny tictactoe generations on the CPU (``device="cpu"``), as
tests/test_pipeline.py runs the reference's; the CLI's flags and defaults
are the reference's plus ``--device``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu import checkpoint as jax_ckpt
from alphatpu.buffer import create_buffer as jax_create_buffer
from alphatpu.buffer import write_samples as jax_write_samples
from alphatpu.games import make_game as jax_make_game
from alphatpu.nets import apply_training
from alphatpu.nets import config_for_game as jax_config_for_game
from alphatpu.nets import init_params
from alphatpu.train import TrainConfig as JaxTrainConfig
from alphatpu.train import make_optimizer
from alphatpu_torch import checkpoint as ckpt
from alphatpu_torch.buffer import create_buffer, write_samples
from alphatpu_torch.duel import DuelConfig
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import MLP, PARAM_NAMES, config_for_game
from alphatpu_torch.pipeline import (
    PipelineConfig, init_pipeline, resume, run_generation, run_training,
)
from alphatpu_torch.selfplay import SelfplayConfig
from alphatpu_torch.train import TrainConfig, adam_init, adam_update

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)


def tiny_config(tmp_path=None, **kw):
    return PipelineConfig(**{**dict(
        selfplay=SelfplayConfig(num_games=16, rollouts=12, cpuct=1.5),
        train=TrainConfig(batch_size=32, epochs=1),
        duel=DuelConfig(num_games=8, rollouts=8),
        buffer_capacity=4096,
        generations=2,
        width=32,
        depth=2,
        ckpt_dir=str(tmp_path) if tmp_path else None,
        device="cpu",
        log=lambda s: None,
    ), **kw})


def _rows(rng, game, n):
    st = rng.integers(0, 2, (n, 2 * game.vectorized_state)).astype(np.int8)
    pol = rng.random((n, game.max_actions), dtype=np.float32)
    ply = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    val = (rng.integers(0, 3, n) / 2.0).astype(np.float32)
    fst = np.where(rng.random((n, game.feature_size)) < 0.5, 1,
                   -1).astype(np.int8)
    return st, pol, ply, val, fst, np.ones(n, bool)


def test_port_loads_a_reference_checkpoint(tmp_path):
    """alphatpu.checkpoint.save_checkpoint's nets, optimizer state (after
    two optax steps) and buffer, read by the port: equal arrays, and the
    port's training forward equals the reference's on the loaded nets."""
    jgame, game = jax_make_game("tictactoe"), make_game("tictactoe")
    jcfg = jax_config_for_game(jgame, width=32, depth=2)
    best = init_params(jax.random.key(0), jcfg)
    train = init_params(jax.random.key(1), jcfg)
    opt = make_optimizer(JaxTrainConfig())
    opt_state = opt.init(train)
    for i in range(2):
        grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01 * (i + 1)),
                             train)
        _, opt_state = opt.update(grads, opt_state, train)
    rng = np.random.default_rng(0)
    jbuf = jax_write_samples(jax_create_buffer(jgame, 64),
                             *(jnp.asarray(x) for x in _rows(rng, game, 40)))
    jax_ckpt.save_checkpoint(
        str(tmp_path), 7, best_params=best, train_params=train,
        opt_state=opt_state, elo=12.5, best_generation=3,
        rng=jax.random.key_data(jax.random.key(2)), buffer=jbuf)

    cfg = config_for_game(game, width=32, depth=2)
    tmpl = MLP(cfg)
    manifest, state = ckpt.load_checkpoint(
        str(tmp_path), best_net=tmpl, train_net=tmpl.copy(trainable=True),
        opt_state=adam_init(tmpl), buffer=create_buffer(game, 64))
    assert manifest["generation"] == 7 and manifest["elo"] == 12.5
    assert state["rng"] is None  # a JAX key is no generator state
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(
            getattr(state["best"], name).detach().numpy(),
            np.asarray(best[name]))
        np.testing.assert_array_equal(
            state["opt"]["mu"][name].numpy(), np.asarray(opt_state[0].mu[name]))
        np.testing.assert_array_equal(
            state["opt"]["nu"][name].numpy(), np.asarray(opt_state[0].nu[name]))
    assert state["train"].base.requires_grad
    assert int(state["opt"]["count"]) == 2
    for field in ("state", "policy", "player", "value", "fstate", "cursor",
                  "total"):
        np.testing.assert_array_equal(
            getattr(state["buffer"], field).numpy(),
            np.asarray(getattr(jbuf, field)), err_msg=field)
    x = np.asarray(jbuf.state[:40], np.float32)
    ref = apply_training(train, jnp.asarray(x))
    got = state["train"].forward_training(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)


def test_reference_loads_a_port_checkpoint(tmp_path):
    """alphatpu.checkpoint.load_checkpoint reads the port's best, train,
    opt and buffer entries exactly, under its own templates."""
    game, jgame = make_game("tictactoe"), jax_make_game("tictactoe")
    cfg = config_for_game(game, width=32, depth=2)
    best = MLP.from_seed(cfg, 0)
    train = MLP.from_seed(cfg, 1, trainable=True)
    opt_state = adam_init(train)
    for i in range(3):
        opt_state = adam_update(
            train, {n: torch.full_like(getattr(train, n), 0.01 * (i + 1))
                    for n in PARAM_NAMES}, opt_state, TrainConfig())
    buf = write_samples(create_buffer(game, 64), *(
        torch.from_numpy(x) for x in _rows(np.random.default_rng(1), game,
                                           50)))
    ckpt.save_checkpoint(str(tmp_path), 4, best_net=best, train_net=train,
                         opt_state=opt_state, elo=-980.0, best_generation=2,
                         rng=torch.Generator().manual_seed(3), buffer=buf)

    jcfg = jax_config_for_game(jgame, width=32, depth=2)
    tmpl = init_params(jax.random.key(0), jcfg)
    manifest, loaded = jax_ckpt.load_checkpoint(
        str(tmp_path), best_params=tmpl, train_params=tmpl,
        opt_state=make_optimizer(JaxTrainConfig()).init(tmpl),
        rng=jax.random.key_data(jax.random.key(0)),
        buffer=jax_create_buffer(jgame, 64))
    assert manifest["generation"] == 4 and manifest["best_generation"] == 2
    adam = loaded["opt"][0]
    assert int(adam.count) == 3 and adam.count.dtype == jnp.int32
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(loaded["best"][name]),
                                      getattr(best, name).detach().numpy())
        np.testing.assert_array_equal(np.asarray(loaded["train"][name]),
                                      getattr(train, name).detach().numpy())
        np.testing.assert_array_equal(np.asarray(adam.mu[name]),
                                      opt_state["mu"][name].numpy())
        np.testing.assert_array_equal(np.asarray(adam.nu[name]),
                                      opt_state["nu"][name].numpy())
    for field in ("state", "policy", "player", "value", "fstate", "cursor",
                  "total"):
        np.testing.assert_array_equal(
            np.asarray(getattr(loaded["buffer"], field)),
            getattr(buf, field).numpy(), err_msg=field)


def test_checkpoint_index_wraps_at_1000(tmp_path):
    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game, width=8, depth=1), 0)
    kw = dict(best_net=net, train_net=net, opt_state=adam_init(net), elo=0.0,
              best_generation=0, rng=torch.Generator().manual_seed(0))
    for gen, index in ((999, 999), (1000, 1000), (1001, 1), (2003, 3)):
        path = ckpt.save_checkpoint(str(tmp_path), gen, **kw)
        assert os.path.basename(path) == f"net{index}.npz"
        with open(tmp_path / "latest.json") as f:
            manifest = json.load(f)
        assert (manifest["generation"], manifest["index"]) == (gen, index)
        assert not manifest["has_buffer"] and not manifest["has_carry"]


def test_two_generations_and_checkpoint(tmp_path):
    game = make_game("tictactoe")
    cfg = tiny_config(tmp_path)
    state = init_pipeline(game, cfg)
    p0 = state.train_net.base.detach().clone()

    state, stats1 = run_generation(game, state, cfg)
    assert stats1["generation"] == 1
    assert stats1["illegal_moves"] == 0
    assert (stats1["wins"] + stats1["draws"] + stats1["losses"]
            + stats1["unfinished"]) == 16
    assert sum(stats1["duel"]) + stats1["duel_unfinished"] == 8
    assert not torch.allclose(p0, state.train_net.base), "no weight changed"
    assert not state.best_net.base.requires_grad
    assert state.train_net.base.requires_grad

    state, stats2 = run_generation(game, state, cfg)
    assert stats2["generation"] == 2
    assert int(state.buffer.total[0]) > 100
    assert set(stats2) == set(stats1) == {
        "generation", "selfplay_s", "train_s", "duel_s", "loss", "duel",
        "duel_unfinished", "elo", "promoted", "wins", "draws", "losses",
        "mean_length", "illegal_moves", "unfinished", "samples_written"}

    assert os.path.exists(os.path.join(cfg.ckpt_dir, "latest.json"))
    fresh = init_pipeline(game, cfg)
    manifest = resume(game, fresh, cfg)
    assert manifest["generation"] == fresh.generation == 2
    assert fresh.elo == state.elo
    assert fresh.best_generation == state.best_generation
    for name in PARAM_NAMES:
        assert torch.equal(getattr(fresh.train_net, name),
                           getattr(state.train_net, name))
        assert torch.equal(getattr(fresh.best_net, name),
                           getattr(state.best_net, name))
        assert torch.equal(fresh.opt_state["mu"][name],
                           state.opt_state["mu"][name])
    assert torch.equal(fresh.rng.get_state(), state.rng.get_state())
    assert fresh.train_net.base.requires_grad


def test_carry_checkpoint_roundtrip(tmp_path):
    """Continuous mode with save_buffer: the carry (in-flight episodes and
    its generator) round-trips exactly, and a resumed run continues as the
    uninterrupted one does."""
    game = make_game("tictactoe")
    cfg = tiny_config(tmp_path, save_buffer=True, generations=2)
    cfg.selfplay = cfg.selfplay._replace(continuous=True, rounds=6)
    state = init_pipeline(game, cfg)
    state, _ = run_generation(game, state, cfg)
    assert int(state.sp_carry.count.sum()) > 0  # some lane mid-episode

    fresh = init_pipeline(game, cfg)
    resume(game, fresh, cfg)
    got, want = fresh.sp_carry, state.sp_carry
    for a, b in zip(got.positions, want.positions):
        assert torch.equal(a, b)
    for f in ("count", "enc", "pol", "player"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.rng.get_state(), want.rng.get_state())
    for f in ("state", "policy", "value", "total", "cursor"):
        assert torch.equal(getattr(fresh.buffer, f), getattr(state.buffer, f))

    state, stats = run_generation(game, state, cfg)
    fresh, fstats = run_generation(game, fresh, cfg)
    for k in ("wins", "draws", "losses", "samples_written", "loss", "duel"):
        assert stats[k] == fstats[k], k
    assert torch.equal(state.train_net.base, fresh.train_net.base)


def test_same_seed_same_run():
    """A run is a function of its seed on a given device."""
    game = make_game("tictactoe")
    runs = []
    for seed in (3, 3, 4):
        cfg = tiny_config(seed=seed, generations=2,
                          selfplay=SelfplayConfig(num_games=8, rollouts=8),
                          duel=DuelConfig(num_games=4, rollouts=4))
        _, history = run_training(game, cfg)
        runs.append([{k: v for k, v in s.items() if not k.endswith("_s")}
                     for s in history])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_cli_parser_matches_reference_flags():
    from alphatpu.cli import build_parser as jax_build_parser
    from alphatpu_torch.cli import build_parser, default_samples

    ours = {a.dest: a.default for a in build_parser()._actions}
    ref = {a.dest: a.default for a in jax_build_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == ref
    ours = {a.dest: a.option_strings for a in build_parser()._actions}
    ref = {a.dest: a.option_strings for a in jax_build_parser()._actions}
    ours.pop("device")
    assert ours == ref
    args = build_parser().parse_args(
        ["--game", "hex7", "--samples", "1024", "--rollout", "32",
         "--generation", "5", "--batchsize", "512", "--cpuct", "2.0",
         "--device", "cpu"])
    assert (args.samples, args.rollout, args.generation, args.batchsize,
            args.cpuct, args.device) == (1024, 32, 5, 512, 2.0, "cpu")
    assert default_samples("connect4") == 32768
    assert default_samples("reversi8x8") == 16384


TORCHRUN = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
            "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}


@pytest.mark.parametrize("argv", [
    ["--devices", "2"], ["--devices", "0"], ["--multihost"],
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--process-id", "0"],
])
def test_cli_refuses_multi_gpu(argv, monkeypatch):
    """Each multi-device flag resolves to its world - (size, rank, init
    method, backend), rank None where the CLI spawns the ranks - and no
    rank is launched.  On the CPU ``--devices 2`` is two gloo ranks at a
    free tcp://localhost port and ``--devices 0`` one rank; ``--multihost``
    joins the world of torchrun's variables or of its three companions,
    which alone are ignored, as the reference ignores them.  On cards
    (torch.cuda patched) ``--devices 2`` with one visible card is refused
    with ValueError, and ``--devices 0`` takes every visible card with
    NCCL."""
    from alphatpu_torch.cli import build_parser, resolve_world

    def world(extra=(), env=None, device="cpu"):
        args = build_parser().parse_args(argv + list(extra)
                                         + ["--device", device])
        plan = resolve_world(args, env={} if env is None else env)
        if plan.init_method and plan.init_method.startswith(
                "tcp://localhost:") and plan.rank is None:
            port = int(plan.init_method.rsplit(":", 1)[1])
            assert 0 < port < 65536
            plan = plan._replace(init_method="tcp://localhost:<free>")
        return tuple(plan)

    def cards(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: "NVIDIA H100 80GB HBM3")

    one = (1, 0, None, None)
    flag = argv[0]
    if flag == "--devices" and argv[1] == "2":
        assert world() == (2, None, "tcp://localhost:<free>", "gloo")
        cards(1)
        with pytest.raises(ValueError, match="--devices 2 requested but "
                                             "only 1 CUDA device"):
            world(device="cuda")
        with pytest.raises(ValueError, match="a card of its own"):
            world(device="cuda:0")
        cards(2)
        assert world(device="cuda") == (2, None, "tcp://localhost:<free>",
                                        "nccl")
    elif flag == "--devices":
        assert world() == one
        cards(4)
        assert world(device="cuda") == (4, None, "tcp://localhost:<free>",
                                        "nccl")
    elif flag == "--multihost":
        assert world(env=TORCHRUN) == (2, 1, "env://", "gloo")
        assert world(env=TORCHRUN, device="cuda") == (2, 1, "env://", "nccl")
        with pytest.raises(ValueError, match="--multihost needs"):
            world()
    elif flag == "--coordinator":
        assert world() == one
        assert world(["--multihost", "--num-processes", "2", "--process-id",
                      "1"]) == (2, 1, "tcp://localhost:1234", "gloo")
    elif flag == "--num-processes":
        assert world() == one
        assert world(["--multihost", "--coordinator", "host0:5",
                      "--process-id", "0"]) == (2, 0, "tcp://host0:5",
                                                "gloo")
    else:
        assert world() == one
        assert world(["--multihost"], env=TORCHRUN) == (2, 0, "env://",
                                                        "gloo")


def test_cli_never_falls_back_to_the_cpu(monkeypatch):
    from alphatpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--game", "tictactoe"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--game", "tictactoe", "--device", "cuda:0"])


def test_cli_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """Two generations, then a resumed third, through main()."""
    from alphatpu_torch.cli import main

    common = ["--device", "cpu", "--game", "tictactoe", "--samples", "16",
              "--rollout", "8", "--batchsize", "32", "--duel-games", "8",
              "--duel-rollouts", "8", "--width", "32", "--depth", "2",
              "--buffer-capacity", "4096", "--ckpt-dir", str(tmp_path / "ck"),
              "--stats-file", str(tmp_path / "stats.jsonl")]
    assert main(common + ["--generation", "2", "--bf16-inference",
                          "--profile-dir", str(tmp_path / "prof")]) == 0
    assert main(common + ["--generation", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at generation 2" in out
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "latest.json", "net1.npz", "net2.npz", "net3.npz"]
    assert os.listdir(tmp_path / "prof") == ["generation1.json"]
    lines = [json.loads(s) for s in open(tmp_path / "stats.jsonl")]
    assert [s["generation"] for s in lines] == [1, 2, 3]
    for s in lines:
        assert s["illegal_moves"] == 0
        assert s["wins"] + s["draws"] + s["losses"] + s["unfinished"] == 16


def test_profile_generation_runs_on_the_cpu(tmp_path):
    """The stage profiler runs end to end and writes one record per
    window; on the CPU it gives wall times and no device metric."""
    from alphatpu_torch.profile_generation import main

    out = tmp_path / "profile.json"
    assert main(["--device", "cpu", "--game", "tictactoe", "--games", "16",
                 "--rollouts", "4", "--rounds", "1",
                 "--width", "16", "--depth", "1", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["samples_written"] > 0
    assert [w["window"].split(",")[0] for w in rec["windows"]] == [
        "selfplay", "train", "duel", "checkpoint with the buffer"]
    for w in rec["windows"]:
        assert w["wall_ms"] > 0 and "idle_share" not in w


def test_profile_generation_profiles_a_checkpoints_net(tmp_path,
                                                     monkeypatch):
    """``--ckpt`` profiles the best net of a checkpoint: its selfplay is
    that net's, not seed 0's."""
    from alphatpu_torch import profile_generation
    from alphatpu_torch.checkpoint import save_checkpoint
    from alphatpu_torch.train import adam_init

    nets = []
    play = profile_generation.selfplay_generation

    def selfplay_generation(game, net, *a, **k):
        nets.append(net.base.detach().clone())
        return play(game, net, *a, **k)

    monkeypatch.setattr(profile_generation, "selfplay_generation",
                        selfplay_generation)
    main = profile_generation.main

    game = make_game("tictactoe")
    best = MLP.from_seed(config_for_game(game), 5)
    train = best.copy(trainable=True)
    path = save_checkpoint(
        str(tmp_path / "ck"), 1, best_net=best, train_net=train,
        opt_state=adam_init(train), elo=0.0, best_generation=1,
        rng=torch.Generator().manual_seed(0))
    recs = []
    for extra in (["--ckpt", path], []):
        out = tmp_path / "profile.json"
        assert main(["--device", "cpu", "--game", "tictactoe", "--games",
                     "16", "--rollouts", "4", "--rounds", "1",
                     "--out", str(out)] + extra) == 0
        recs.append(json.loads(out.read_text()))
    assert recs[0]["args"]["ckpt"] == path
    # the stage and both windows' calls, then the same without --ckpt
    assert len(nets) == 6
    for got in nets[:3]:
        torch.testing.assert_close(got, best.base, rtol=0, atol=0)
    assert not torch.equal(nets[3], best.base)
    assert recs[0]["samples_written"] > 0
    assert [w["window"] for w in recs[0]["windows"]] == [
        w["window"] for w in recs[1]["windows"]]


def test_profile_summary_keeps_whole_kernel_names():
    """The top kernels by device time, most first, at most eight, each
    name whole: the functor and dtype of a templated elementwise kernel
    come after its 80th character."""
    from alphatpu_torch.profile_generation import top_kernels

    long = ("void at::native::elementwise_kernel<128, 2, at::native::"
            "gpu_kernel_impl_nocast<at::native::BitwiseAndFunctor<long> >"
            "(at::TensorIteratorBase&, ...)::{lambda(int)#1}>(int, ...)")
    assert len(long) > 80
    by_name = {f"k{i}": float(i) for i in range(12)}
    by_name[long] = 100.0
    top = top_kernels(by_name)
    assert top[0] == (long, 100.0)
    assert [n for n, _ in top[1:]] == [f"k{i}" for i in range(11, 4, -1)]
    assert top_kernels(by_name, 2) == [(long, 100.0), ("k11", 11.0)]


def test_profile_names_every_rules_kernel():
    """Each rules kernel's device ms and launches by its function's name,
    every instantiation summed, whether or not it is in the top eight; a
    kernel the window did not run reports 0."""
    from types import SimpleNamespace

    from alphatpu_torch.profile_generation import RULES_KERNELS, rules_kernels

    def event(name, us):
        return SimpleNamespace(name=name, device_time_total=us)

    kernels = [
        event("void (anonymous namespace)::hex_is_over_kernel<7, 8>(long "
              "const*, signed char const*, bool*, signed char*, ...)", 6.0),
        event("void (anonymous namespace)::hex_is_over_kernel<2, 2>(...)",
              3.0),
        event("void (anonymous namespace)::reversi_play_kernel<8, long>"
              "(...)", 4.0),
        event("void (anonymous namespace)::reversi_is_over_kernel<8>(...)",
              2.5),
        event("void walk::select_apply_packed_kernel<32, 6>(...)", 100.0),
    ]
    got = rules_kernels(kernels)
    assert set(got) == set(RULES_KERNELS)
    assert got["hex_is_over_kernel"] == {"ms": 0.009, "launches": 2}
    assert got["reversi_play_kernel"] == {"ms": 0.004, "launches": 1}
    assert got["reversi_is_over_kernel"] == {"ms": 0.0025, "launches": 1}
    assert got["line_is_over_kernel"] == {"ms": 0.0, "launches": 0}
