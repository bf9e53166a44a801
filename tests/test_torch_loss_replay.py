"""The port's tictactoe loss replay
(``alphatpu_torch.benchmarks.ttt_loss_replay``) against
``benchmarks/ttt_loss_replay.py``, loaded by path (it imports jax only
inside ``analyze``).

``solve`` is a copy: it must give the reference's value on every
tictactoe position reachable from the empty board.  ``analyze`` runs in
both packages on one checkpoint, written by the port and read by both, at
tictactoe's reference size (6x128), with the same uniforms: the test
recreates the reference's key stream (``probe_uniforms``) and feeds it to
the port.  The weights keep every product and partial sum of the forward
on a coarse dyadic grid (base and tower in {-1/2, 0, 1/2}, sparse; heads
in {-1/64, 0, 1/64}), exact in float32 in any order, so the two nets
agree up to the rounding of exp and sigmoid; both search with the f32
engine (16 games are no multiple of the reference's 128-lane block).  The
score and the verdict on every lost game must be equal.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from alphatpu_torch.benchmarks import ttt_loss_replay as port
from alphatpu_torch.checkpoint import save_checkpoint
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import config_for_game, params_from_jax
from alphatpu_torch.train import adam_init

from test_torch_probe import probe_uniforms

REPO = Path(__file__).resolve().parents[1]

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "jax_ttt_loss_replay", REPO / "benchmarks" / "ttt_loss_replay.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reachable():
    """Every (me, opp) occupancy pair reachable by play from the empty
    board, stopping at a completed line."""
    seen, todo = set(), [(0, 0)]
    while todo:
        me, opp = todo.pop()
        if (me, opp) in seen:
            continue
        seen.add((me, opp))
        if any((opp & m) == m for m in port.LINE_MASKS) or (
                me | opp) == port.FULL:
            continue
        for a in range(9):
            if not (me | opp) & (1 << a):
                todo.append((opp, me | (1 << a)))
    return seen


def test_solve_matches_reference():
    ref = _reference()
    positions = _reachable()
    assert len(positions) == 5478  # tictactoe's legal positions
    assert ref.LINE_MASKS == port.LINE_MASKS and ref.FULL == port.FULL
    values = [port.solve(me, opp) for me, opp in positions]
    assert values == [ref.solve(me, opp) for me, opp in positions]
    assert port.solve(0, 0) == 0 and set(values) == {-1, 0, 1}


def exact_params(cfg, seed):
    """Weights whose forward is exact in float32 (module doc)."""
    rng = np.random.default_rng(seed)

    def w(shape, step, density):
        sign = rng.choice(np.array([-1.0, 1.0]), size=shape)
        return (sign * step * (rng.random(shape) < density)).astype(
            np.float32)

    return {
        "base": w((cfg.in_dim, cfg.width), 0.5, 0.5),
        "res": w((cfg.depth, cfg.width, cfg.width), 0.5, 1 / 16),
        "policy_w": w((cfg.width, cfg.actions), 1 / 64, 0.25),
        "policy_b": np.zeros(cfg.actions, np.float32),
        "value_w": w((cfg.width, 1), 1 / 64, 0.25),
        "value_b": np.zeros(1, np.float32),
        "feature_w": w((cfg.width, cfg.fsize), 1 / 64, 0.25),
        "feature_b": np.zeros(cfg.fsize, np.float32),
    }


@pytest.mark.parametrize("temp_moves,seed", [(8, 0), (2, 3)])
def test_loss_replay_matches_reference(temp_moves, seed, tmp_path, capsys,
                                       monkeypatch):
    G, R = 16, 8
    game = make_game("tictactoe")
    cfg = config_for_game(game)
    net = params_from_jax(exact_params(cfg, 40 + seed), cfg, trainable=True)
    ckpt = save_checkpoint(
        str(tmp_path), 1, best_net=net, train_net=net,
        opt_state=adam_init(net), elo=0.0, best_generation=1,
        rng=torch.Generator().manual_seed(0))
    monkeypatch.setenv("ALPHATPU_NO_PACK", "1")

    ref = _reference().analyze(ckpt, temp_moves, seed, games=G, rollouts=R)
    T = game.max_game_length
    ours = port.analyze(ckpt, temp_moves, seed, games=G, rollouts=R,
                        device="cpu",
                        uniforms=probe_uniforms(jax.random.key(seed), T, R,
                                                min(T, R), G))
    assert ours == ref
    assert sum(ours["score"]) == G
    assert ours["losses"], "no game lost: nothing was attributed"
    assert all("sampling_induced" in v or "note" in v
               for v in ours["losses"])
    printed = capsys.readouterr().out
    assert printed.count('"ckpt"') == 2  # both printed their JSON


def test_main_runs_on_the_cpu_and_refuses_without_a_card(tmp_path, capsys,
                                                          monkeypatch):
    game = make_game("tictactoe")
    cfg = config_for_game(game)
    net = params_from_jax(exact_params(cfg, 7), cfg, trainable=True)
    ckpt = save_checkpoint(
        str(tmp_path), 2, best_net=net, train_net=net,
        opt_state=adam_init(net), elo=0.0, best_generation=2,
        rng=torch.Generator().manual_seed(0))
    monkeypatch.setattr(port, "analyze", lambda *a, **kw: calls.append(
        (a, kw)))
    calls = []
    assert port.main([ckpt, "2", "5", "--device", "cpu"]) == 0
    assert calls == [((ckpt, 2, 5), {"device": "cpu"})]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([ckpt])
