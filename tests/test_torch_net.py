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

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)


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


@pytest.mark.parametrize("name", ["connect4", "hex5", "reversi6x6"])
def test_training_forward_matches_reference(name):
    """forward_training (logits, value, tanh feature) against
    apply_training on the same Glorot weights: rtol 1e-5, atol 1e-5."""
    from alphatpu.nets import apply_training

    game = make_game(name)
    cfg = config_for_game(game, width=32, depth=2)
    flat = init_numpy(cfg, seed=5)
    flat = {k: v + (0.01 if k.endswith("_b") else 0.0)
            for k, v in flat.items()}  # nonzero biases
    x = _inputs(3, 256, cfg.in_dim)
    ref = jax.jit(apply_training)({k: jnp.asarray(v) for k, v in flat.items()},
                                  jnp.asarray(x))
    net = params_from_jax(flat, cfg, trainable=True)
    got = net.forward_training(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)
    assert got[2].shape == (256, cfg.fsize) and got[2].requires_grad
    # the inference forward is the training forward without its third head
    logits, value = net(torch.from_numpy(x))
    np.testing.assert_array_equal(logits.detach().numpy(),
                                  got[0].detach().numpy())


def test_bf16_inference_matches_reference():
    """compute_dtype=bfloat16 keeps the tower's activations in bfloat16
    and sums the heads in float32, as apply_inference(compute_dtype=
    bfloat16) does: atol 2e-2."""
    game = make_game("connect4")
    cfg = config_for_game(game, width=64, depth=3)
    flat = init_numpy(cfg, seed=6)
    x = _inputs(4, 256, cfg.in_dim)
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    ref_logits, ref_value = jax.jit(apply_inference, static_argnums=2)(
        jparams, jnp.asarray(x), jnp.bfloat16)
    net = params_from_jax(flat, cfg)
    logits, value = net(torch.from_numpy(x), torch.bfloat16)
    assert logits.dtype == value.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=2e-2)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_value),
                               atol=2e-2)
    f32_logits, _ = net(torch.from_numpy(x))
    assert not torch.equal(logits, f32_logits)  # the tower did run in bf16


def test_params_to_numpy_round_trip():
    """params_to_numpy writes the reference's flat names and layouts, and
    params_from_jax reads them back bit for bit; copy() makes a trainable
    twin that shares no storage."""
    from alphatpu_torch.nets import PARAM_NAMES, params_to_numpy

    game = make_game("tictactoe")
    cfg = config_for_game(game, width=16, depth=2)
    net = MLP.from_seed(cfg, seed=7)
    flat = params_to_numpy(net, "train/")
    jflat = _flatten({"train": init_params(
        jax.random.key(0), jax_config_for_game(jax_make_game("tictactoe"),
                                               width=16, depth=2))})
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in jflat.items()}
    back = params_from_jax(flat, cfg, prefix="train/")
    for name in PARAM_NAMES:
        assert torch.equal(getattr(back, name), getattr(net, name))
    twin = net.copy(trainable=True)
    assert all(p.requires_grad for p in twin.parameters())
    with torch.no_grad():
        twin.base.add_(1.0)
    assert not torch.equal(twin.base, net.base)
