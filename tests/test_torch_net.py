"""The port's MLP against ``alphatpu.nets.apply_inference`` on the same
weights: logits and values to rtol 1e-5 (the two frameworks' matmuls sum
in different orders; everything is float32).  An output near zero is a
sum of ``width`` terms of order one that cancel, so its error is absolute:
atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.checkpoint import _flatten
from alphatpu.games import make_game as jax_make_game
from alphatpu.nets import apply_inference
from alphatpu.nets import config_for_game as jax_config_for_game
from alphatpu.nets import init_params
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import MLP, config_for_game, init_numpy, params_from_jax


def _inputs(seed, n, in_dim):
    # connect4-like encodings: each cell in at most one of the two planes
    rng = np.random.default_rng(seed)
    cells = in_dim // 2
    owner = rng.integers(0, 3, size=(n, cells))
    return np.concatenate([owner == 1, owner == 2], axis=1).astype(np.float32)


@pytest.mark.parametrize("width,depth", [(32, 2), (512, 4)])
def test_forward_matches_reference(width, depth):
    game = make_game("connect4")
    cfg = config_for_game(game, width=width, depth=depth)
    flat = init_numpy(cfg, seed=width)
    x = _inputs(1, 512, cfg.in_dim)
    ref_logits, ref_value = jax.jit(apply_inference)(
        {k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(x))
    net = params_from_jax(flat, cfg)
    logits, value = net(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_value),
                               rtol=1e-5, atol=1e-5)
    assert logits.shape == (512, 7) and value.shape == (512,)


def test_params_from_checkpoint_keys():
    """The ``best/...`` keys that checkpoint._flatten writes: the best net
    is loaded, the other entries are ignored; JAX-initialized weights give
    the JAX forward."""
    jgame = jax_make_game("connect4")
    jcfg = jax_config_for_game(jgame, width=64, depth=3)
    best = init_params(jax.random.key(0), jcfg)
    train = init_params(jax.random.key(1), jcfg)
    flat = _flatten({"best": best, "train": train})
    assert "best/base" in flat and "train/res" in flat
    cfg = config_for_game(make_game("connect4"), width=64, depth=3)
    assert tuple(cfg) == tuple(jcfg)
    net = params_from_jax(flat, cfg)
    np.testing.assert_array_equal(net.res.numpy(), np.asarray(best["res"]))
    x = _inputs(2, 64, cfg.in_dim)
    ref_logits, ref_value = apply_inference(best, jnp.asarray(x))
    logits, value = net(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_value),
                               rtol=1e-5, atol=1e-5)


def test_config_and_shape_checks():
    game = make_game("connect4")
    assert config_for_game(game) == (84, 7, 42, 512, 4)
    cfg = config_for_game(game, width=32, depth=2)
    flat = init_numpy(cfg, seed=0)
    flat["res"] = flat["res"][:1]
    with pytest.raises(ValueError, match="res"):
        params_from_jax(flat, cfg)
    net = MLP.from_seed(cfg, seed=3)
    assert not any(p.requires_grad for p in net.parameters())
    assert float(net.policy_b.abs().sum()) == 0.0
    assert not torch.backends.cuda.matmul.allow_tf32
