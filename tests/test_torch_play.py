"""The port's play surface against the reference: the copied rule oracles
and CPU engine (``cpu_mcts``), each game's text ``render``, the SVG boards
and interactive play.

The copies are held to their originals on the same states and uniforms;
the CPU engine's numpy forward to the port's ``MLP`` to 1e-5.  The games'
text boards and the SVG strings must equal the reference's on the same
move sequences.  ``interactive.main`` is driven through a monkeypatched
``input``: with ``--cpu`` (the numpy engine, seeded) its transcript must
equal the reference's on the same checkpoint; the batched engine (a G = 1
``run_mcts``) must play a legal game to its end.
"""
import builtins

import jax
import numpy as np
import pytest
import torch

from alphatpu import cpu_mcts as jax_cpu_mcts
from alphatpu import interactive as jax_interactive
from alphatpu import render as jax_render
from alphatpu.games import make_game as jax_make_game
from alphatpu_torch import cpu_mcts, interactive, oracles, render
from alphatpu_torch.checkpoint import save_checkpoint
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import MLP, config_for_game, params_to_numpy
from alphatpu_torch.train import adam_init

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

FAMILIES = ("tictactoe", "gobang8", "connect4", "hex7", "reversi6x6")


def oracle_pair(name):
    """(port oracle, reference oracle) for a game name."""
    ours = cpu_mcts.oracle_for_game(make_game(name))
    ref = jax_cpu_mcts.oracle_for_game(jax_make_game(name))
    assert type(ours).__name__ == type(ref).__name__
    return ours, ref


def _same_state(a, b):
    assert a["player"] == b["player"]
    np.testing.assert_array_equal(a["mover"], b["mover"])
    np.testing.assert_array_equal(a["other"], b["other"])


@pytest.mark.parametrize("name", FAMILIES)
def test_oracles_match_reference(name):
    """Random playouts through both copies: the same legal moves, states,
    planes and results at every ply."""
    ours, ref = oracle_pair(name)
    rng = np.random.default_rng(len(name))
    for _ in range(3):
        a, b = ours.initial(), ref.initial()
        while True:
            _same_state(a, b)
            for x, y in zip(ours.planes(a), ref.planes(b)):
                np.testing.assert_array_equal(x, y)
            over = ours.is_over(a)
            assert over == ref.is_over(b)
            if over[0]:
                break
            legal = ours.legal_actions(a)
            assert legal == ref.legal_actions(b)
            move = legal[rng.integers(len(legal))]
            a, b = ours.play(a, move), ref.play(b, move)


def test_numpy_net_matches_the_port_forward():
    """cpu_mcts.numpy_net on params_to_numpy(net) against MLP.forward on the
    encoded states, to 1e-5."""
    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game, width=64, depth=3), 3)
    prior_fn, value_fn = cpu_mcts.numpy_net(params_to_numpy(net))
    oracle = oracles.OracleConnect4()
    st = oracle.initial()
    for a in [3, 2, 4, 2, 6, 0]:
        st = oracle.play(st, a)
        x = torch.from_numpy(np.concatenate(oracle.planes(st)))[None]
        logits, v = net(x)
        np.testing.assert_allclose(
            prior_fn(st), torch.softmax(logits, -1)[0].detach().numpy(),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(value_fn(st), float(v[0]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name,training", [("tictactoe", True),
                                           ("connect4", False),
                                           ("reversi6x6", True)])
def test_scalar_mcts_matches_reference(name, training):
    """ScalarMCTS of both packages on the same state, net and uniforms:
    the same nodes, per-node stats and root policy, exactly."""
    ours_o, ref_o = oracle_pair(name)
    game = make_game(name)
    params = params_to_numpy(MLP.from_seed(
        config_for_game(game, width=32, depth=2), 5))
    st_a, st_b = ours_o.initial(), ref_o.initial()
    for move in ours_o.legal_actions(st_a)[:2]:
        st_a, st_b = ours_o.play(st_a, move), ref_o.play(st_b, move)
    probs = np.random.default_rng(2).random((48, game.max_game_length),
                                            dtype=np.float32)
    engines = [
        m.ScalarMCTS(o, game.max_actions, 1.5, training, *m.numpy_net(params))
        for m, o in ((cpu_mcts, ours_o), (jax_cpu_mcts, ref_o))]
    (na, pa), (nb, pb) = (e.search(s, probs)
                          for e, s in zip(engines, (st_a, st_b)))
    np.testing.assert_array_equal(pa, pb)
    assert len(na) == len(nb) > 1
    for x, y in zip(na, nb):
        assert (x.parent, x.action_from, x.expanded) == (
            y.parent, y.action_from, y.expanded)
        for f in ("prior", "policy", "q", "visits"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_mcts_context_matches_reference():
    """MctsContext on the port's params_to_numpy dict and on the same
    arrays in the reference: the same (pi, v) move after move."""
    game, jgame = make_game("connect4"), jax_make_game("connect4")
    params = params_to_numpy(MLP.from_seed(
        config_for_game(game, width=32, depth=2), 6))
    ours = cpu_mcts.MctsContext(1.5, game, params, seed=4)
    ref = jax_cpu_mcts.MctsContext(1.5, jgame, params, seed=4)
    st = ours.oracle.initial()
    for _ in range(3):
        pa, va = ours(st, 24)
        pb, vb = ref(st, 24)
        np.testing.assert_array_equal(pa, pb)
        assert va == vb
        st = ours.oracle.play(st, int(np.argmax(pa)))


def play_both(name, seq):
    """The positions after ``seq`` in the port (one game) and the
    reference."""
    game, jgame = make_game(name), jax_make_game(name)
    pos, jpos = game.initial(1), jgame.initial()
    play = jax.jit(jgame.play)
    for a in seq:
        pos = game.play(pos, torch.tensor([a]))
        jpos = play(jpos, a)
    return game, pos, jgame, jpos


def random_sequences(name, n=3):
    """``n`` legal move sequences by the reference's rules (the first
    empty), each stopping before the game ends."""
    jgame = jax_make_game(name)
    play, legal_mask, is_over = (jax.jit(f) for f in (
        jgame.play, jgame.legal_mask, jgame.is_over))
    rng = np.random.default_rng(len(name))
    out = [[]]
    for _ in range(n - 1):
        pos, seq = jgame.initial(), []
        for _ in range(int(rng.integers(1, jgame.max_game_length))):
            legal = np.flatnonzero(np.asarray(legal_mask(pos)))
            a = int(legal[rng.integers(len(legal))])
            nxt = play(pos, a)
            if bool(is_over(nxt)[0]):
                break
            pos = nxt
            seq.append(a)
        out.append(seq)
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_render_and_svg_match_reference(name):
    for seq in random_sequences(name):
        game, pos, jgame, jpos = play_both(name, seq)
        text = game.render(pos)
        assert text == jgame.render(jpos), seq
        assert text.count("X") + text.count("O") >= len(seq)
        assert render.board_svg(game, pos) == jax_render.board_svg(jgame,
                                                                   jpos)


@pytest.mark.parametrize("name", FAMILIES + ("reversi8x8",))
def test_move_names_match_reference(name):
    game, jgame = make_game(name), jax_make_game(name)
    for a in range(game.max_actions):
        text = interactive.move_name(game, a)
        assert text == jax_interactive.move_name(jgame, a)
        assert interactive.parse_move(game, text) == a
    for text in ("", "pass", "12", "zz", "a0", " B2 ", "q9"):
        assert interactive.parse_move(game, text) == \
            jax_interactive.parse_move(jgame, text), text


def scripted_input(transcript):
    """An ``input`` that first answers something illegal, then always the
    first legal move its prompt lists."""
    answers = iter(["zz"])

    def fake(prompt):
        transcript.append(prompt)
        try:
            return next(answers)
        except StopIteration:
            return prompt.split("(", 1)[1].split()[0].rstrip("):")
    return fake


def _checkpoint(tmp_path, game, width, depth):
    net = MLP.from_seed(config_for_game(game, width=width, depth=depth), 8)
    train = net.copy(trainable=True)
    return save_checkpoint(str(tmp_path), 1, best_net=net, train_net=train,
                           opt_state=adam_init(train), elo=0.0,
                           best_generation=1,
                           rng=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("second", [False, True])
def test_interactive_cpu_engine_plays_the_reference_game(tmp_path, second,
                                                         monkeypatch, capsys):
    """``--cpu``: the numpy engine from the same checkpoint, the same
    scripted human; the whole transcript equals the reference's."""
    path = _checkpoint(tmp_path, make_game("tictactoe"), 16, 1)
    argv = ["--game", "tictactoe", "--ckpt", path, "--readout", "16",
            "--width", "16", "--depth", "1", "--cpu"] + (
                ["--second"] if second else [])
    outs = []
    for main in (interactive.main, jax_interactive.main):
        prompts = []
        monkeypatch.setattr(builtins, "input", scripted_input(prompts))
        assert main(argv) == 0
        outs.append((capsys.readouterr().out, prompts))
    assert outs[0] == outs[1]
    out = outs[0][0]
    assert "illegal move" not in out  # "zz" does not parse
    assert "game over: " in out and out.count("engine plays") >= 2


def test_interactive_batched_engine_plays_a_game(tmp_path, monkeypatch,
                                                 capsys):
    """The batched engine (G = 1 run_mcts on the CPU's plain kernels),
    the human moving second, an SVG written each ply."""
    path = _checkpoint(tmp_path, make_game("connect4"), 16, 1)
    svg = tmp_path / "board.svg"
    prompts = []
    monkeypatch.setattr(builtins, "input", scripted_input(prompts))
    assert interactive.main(["--game", "connect4", "--ckpt", path,
                             "--readout", "12", "--width", "16", "--depth",
                             "1", "--second", "--device", "cpu", "--svg",
                             str(svg)]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"loaded {path}")
    assert "game over: " in out
    moves = out.count("engine plays") + len(prompts) - 1
    assert 7 <= moves <= 42
    assert svg.read_text().startswith("<svg")


def test_make_engine_allocates_the_tree_once(monkeypatch):
    from alphatpu_torch.mcts import tree as tree_mod

    calls = []
    real = tree_mod.init_tree
    monkeypatch.setattr(tree_mod, "init_tree",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game, width=16, depth=1), 0)
    choose = interactive.make_engine(game, net, 8, 1.5)
    pos = game.initial(1)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        action, pi = choose(pos, gen)
        assert pi.shape == (9,) and bool(game.legal_mask(pos)[0, action])
        assert abs(float(pi.sum()) - 1.0) < 1e-3  # the Newton tolerance
        pos = game.play(pos, torch.tensor([action]))
    assert len(calls) == 1


def test_interactive_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interactive.main(["--game", "tictactoe"])
