"""Properties of the port as a package, and its kernels on the card.

The CPU tests check that ``alphatpu_torch`` never imports JAX and builds
nothing at import.  The tests marked ``cuda`` hold each CUDA kernel to its
plain torch version on the card; they skip where torch finds no CUDA device.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
MODULES = (
    "alphatpu_torch", "alphatpu_torch.bitboard", "alphatpu_torch.games",
    "alphatpu_torch.games.connect4", "alphatpu_torch.nets",
    "alphatpu_torch.mcts.tree", "alphatpu_torch.mcts.newton",
    "alphatpu_torch.mcts.kernels", "alphatpu_torch.mcts.search",
    "alphatpu_torch.buffer", "alphatpu_torch.selfplay",
    "alphatpu_torch._build",
)


def test_port_never_imports_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {MODULES!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "alphatpu.")))
        assert not bad, bad
        from alphatpu_torch import _build
        assert _build.load_library.cache_info().currsize == 0  # nothing built
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_paths_are_inside_the_package():
    from alphatpu_torch import _build

    assert _build.BUILD_DIR.parent == _build.PACKAGE_DIR
    names = {p.name for p in _build.sources()}
    assert names == {"select_apply_packed.cu", "backup.cu"}
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    for flag in ("arch=compute_90a,code=sm_90a", "-fmad=false"):
        assert flag in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    # .gitignore keeps built libraries out of the repository
    assert "alphatpu_torch/_build/" in (REPO / ".gitignore").read_text()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no "
                    "CPU mode, their plain versions are tested on the CPU")
    return torch.device("cuda")


def _grown(device, G, V, seed):
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game

    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game, width=64, depth=2), seed,
                        device=device)
    tree = init_tree(game, game.initial(G, device), V)
    run_mcts(game, net, tree, rollouts=V - 2, cpuct=1.5, training=True,
             generator=torch.Generator(device=device).manual_seed(seed))
    return game, tree


@pytest.mark.cuda
def test_select_apply_packed_kernel_matches_plain(cuda):
    from alphatpu_torch.mcts import kernels as K

    game, tree = _grown(cuda, 1024, 32, 0)
    D = min(game.max_game_length, 32)
    S = K.value_scale(32)
    packed = K.pack_stats(tree.wsum, tree.visits, S)
    probs = torch.rand((D, 1024), device=cuda)
    pend = K.empty_pending(D, game.max_actions, 1024, cuda)
    a = (tree.prior.clone(), packed.clone())
    b = (tree.prior.clone(), packed.clone())
    before = K.select_apply_packed.launches
    sk = K.select_apply_packed(*a, tree.parent, tree.action_from,
                               tree.expanded, probs, pend, 1.5, S)
    sp = K.select_apply_packed_plain(*b, tree.parent, tree.action_from,
                                     tree.expanded, probs, pend, 1.5, S)
    torch.cuda.synchronize()
    assert K.select_apply_packed.launches == before + 1
    for x, y in zip(a + tuple(sk), b + tuple(sp)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_backup_kernel_matches_plain(cuda):
    from alphatpu_torch.mcts import kernels as K

    game, tree = _grown(cuda, 1024, 32, 1)
    D = min(game.max_game_length, 32)
    sel = K.select_apply_packed_plain(
        tree.prior.clone(), K.pack_stats(tree.wsum, tree.visits, 1024),
        tree.parent, tree.action_from, tree.expanded,
        torch.rand((D, 1024), device=cuda),
        K.empty_pending(D, game.max_actions, 1024, cuda), 1.5, 1024)
    length = (sel.nodes >= 0).sum(0, dtype=torch.int32)
    value = torch.rand((1024,), device=cuda)
    a = (tree.wsum.clone(), tree.visits.clone())
    b = (tree.wsum.clone(), tree.visits.clone())
    K.backup(*a, sel.nodes, sel.actions, length, value)
    K.backup_plain(*b, sel.nodes, sel.actions, length, value)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], rtol=1e-6, atol=0.0)
