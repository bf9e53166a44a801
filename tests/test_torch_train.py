"""The port's learner against ``alphatpu.train``.

Across frameworks the loss and its gradients are compared on one batch
(rtol 1e-5, atol 1e-6: float32 sums in different orders), and the
optimizer on the *same* gradients fed from numpy (rtol 1e-6).  k-step
weights are not compared across frameworks: Adam's ``g / sqrt(nu)`` turns
last-bit differences of near-zero gradients into full-size steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphatpu.train import TrainConfig as JaxTrainConfig
from alphatpu.train import loss_fn as jax_loss_fn
from alphatpu.train import make_optimizer
from alphatpu_torch import train as T
from alphatpu_torch.buffer import create_buffer, write_samples
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import (
    MLP, PARAM_NAMES, config_for_game, init_numpy, params_from_jax,
)
from alphatpu_torch.train import (
    TrainConfig, adam_init, adam_update, loss_fn, train_epoch,
)

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)


def _batch(game, n, rng):
    st = rng.integers(0, 2, (n, 2 * game.vectorized_state)).astype(np.int8)
    pol = rng.random((n, game.max_actions), dtype=np.float32)
    pol /= pol.sum(-1, keepdims=True)
    ply = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    val = (rng.integers(0, 3, n) / 2.0).astype(np.float32)
    fst = np.where(rng.random((n, game.feature_size)) < 0.5, 1,
                   -1).astype(np.int8)
    return st, pol, ply, val, fst


def _filled_buffer(game, n, rng):
    st, pol, ply, val, fst = _batch(game, n, rng)
    buf = create_buffer(game, n)
    return write_samples(buf, *(torch.from_numpy(x) for x in
                                (st, pol, ply, val, fst)),
                         torch.ones(n, dtype=torch.bool))


def test_train_config_defaults_match_reference():
    assert tuple(TrainConfig()) == tuple(JaxTrainConfig())
    assert TrainConfig._fields == JaxTrainConfig._fields


@pytest.mark.parametrize("name", ["tictactoe", "connect4"])
def test_loss_and_gradients_match_reference(name):
    game = make_game(name)
    cfg = config_for_game(game, width=32, depth=2)
    flat = init_numpy(cfg, seed=1)
    rng = np.random.default_rng(2)
    st, pol, _, val, fst = _batch(game, 64, rng)
    x, f = st.astype(np.float32), fst.astype(np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss_fn))(
        {k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(x),
        jnp.asarray(pol), jnp.asarray(val), jnp.asarray(f), 1e-3)

    net = params_from_jax(flat, cfg, trainable=True)
    loss = loss_fn(net, torch.from_numpy(x), torch.from_numpy(pol),
                   torch.from_numpy(val), torch.from_numpy(f), 1e-3)
    grads = torch.autograd.grad(loss, [getattr(net, n) for n in PARAM_NAMES])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-6)
    for n, g in zip(PARAM_NAMES, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        assert np.abs(g.numpy()).max() > 0, n  # every head takes gradient


def test_optimizer_matches_optax_on_the_same_gradients():
    """Three steps of the hand-written chain and of optax's
    scale_by_adam -> scale(lr) -> add_decayed_weights(wd) -> scale(-1) on
    the same gradients: weights, mu, nu and count agree."""
    game = make_game("tictactoe")
    cfg = config_for_game(game, width=16, depth=2)
    tcfg = TrainConfig(lr=3e-3, weight_decay=1e-2)
    flat = init_numpy(cfg, seed=3)
    flat = {k: v + 0.05 for k, v in flat.items()}  # nonzero biases decay too
    rng = np.random.default_rng(4)
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(
        -4, 1, v.shape)).astype(np.float32) for k, v in flat.items()}
        for _ in range(3)]

    opt = make_optimizer(JaxTrainConfig(lr=tcfg.lr,
                                        weight_decay=tcfg.weight_decay))
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    jstate = opt.init(jparams)
    net = params_from_jax(flat, cfg, trainable=True)
    state = adam_init(net)
    for g in grads:
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = adam_update(net, {k: torch.from_numpy(v)
                                  for k, v in g.items()}, state, tcfg)
    adam = jstate[0]
    assert int(state["count"]) == int(adam.count) == 3
    assert state["count"].dtype == torch.int32
    for n in PARAM_NAMES:
        np.testing.assert_allclose(getattr(net, n).detach().numpy(),
                                   np.asarray(jparams[n]), rtol=1e-6,
                                   err_msg=n)
        np.testing.assert_allclose(state["mu"][n].numpy(),
                                   np.asarray(adam.mu[n]), rtol=1e-6)
        np.testing.assert_allclose(state["nu"][n].numpy(),
                                   np.asarray(adam.nu[n]), rtol=1e-6)


def test_zero_gradient_step_is_decay_not_scaled_by_lr():
    """With a zero gradient the Adam step is 0, and what is left is
    ``p - wd * p``: the decay is not multiplied by lr, and biases decay."""
    cfg = config_for_game(make_game("tictactoe"), width=8, depth=1)
    net = MLP.from_seed(cfg, 0, trainable=True)
    with torch.no_grad():
        net.policy_b.fill_(0.5)
    before = {n: getattr(net, n).detach().clone() for n in PARAM_NAMES}
    tcfg = TrainConfig(lr=0.5, weight_decay=0.25)
    adam_update(net, {n: torch.zeros_like(before[n]) for n in PARAM_NAMES},
                adam_init(net), tcfg)
    for n in PARAM_NAMES:
        torch.testing.assert_close(getattr(net, n).detach(),
                                   before[n] - 0.25 * before[n],
                                   rtol=0, atol=0)
    assert float(net.policy_b[0].detach()) == 0.375


@pytest.mark.parametrize("n,batch,updates", [
    (2048, 64, 31), (128, 64, 1), (100, 64, 1), (64 * 5 + 3, 64, 4), (0, 8, 1),
])
def test_update_count(n, batch, updates, monkeypatch):
    """max(nsamples // batch - 1, 1) updates per epoch, nsamples =
    min(buffer size, max_samples)."""
    game = make_game("tictactoe")
    buf = (_filled_buffer(game, n, np.random.default_rng(5)) if n else
           create_buffer(game, 16))
    calls = []
    orig = T.sample_batch
    monkeypatch.setattr(T, "sample_batch",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    net = MLP.from_seed(config_for_game(game, width=8, depth=1), 0,
                        trainable=True)
    state, loss = train_epoch(net, adam_init(net), buf,
                              torch.Generator().manual_seed(0),
                              TrainConfig(batch_size=batch))
    assert len(calls) == updates == int(state["count"])
    assert torch.isfinite(loss)
    calls.clear()
    train_epoch(net, adam_init(net), buf, torch.Generator().manual_seed(0),
                TrainConfig(batch_size=batch, max_samples=batch * 3))
    assert len(calls) == (2 if n >= 3 * batch else updates)


def test_injected_indices_and_sampling():
    """``indices`` replaces each update's draw; a drawn batch lies inside
    the valid rows."""
    from alphatpu_torch.buffer import sample_batch

    game = make_game("tictactoe")
    buf = _filled_buffer(game, 256, np.random.default_rng(6))
    idx = torch.arange(8)
    st, pol, val, fst = sample_batch(buf, None, 8, idx)
    assert st.dtype == fst.dtype == torch.float32
    assert torch.equal(st, buf.state[:8].float())
    cfg = config_for_game(game, width=8, depth=1)
    runs = []
    for _ in range(2):
        net = MLP.from_seed(cfg, 0, trainable=True)
        _, loss = train_epoch(net, adam_init(net), buf, None,
                              TrainConfig(batch_size=64),
                              indices=[torch.arange(i, i + 64)
                                       for i in range(3)])
        runs.append((loss, net.base.detach().clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    small = create_buffer(game, 1024)
    write_samples(small, *(torch.from_numpy(x) for x in
                           _batch(game, 5, np.random.default_rng(7))),
                  torch.ones(5, dtype=torch.bool))
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        st, *_ = sample_batch(small, gen, 16)
        assert bool((st.sum(-1) > 0).all())  # never an unwritten row


def test_train_epoch_reduces_loss():
    game = make_game("tictactoe")
    buf = _filled_buffer(game, 2048, np.random.default_rng(0))
    net = MLP.from_seed(config_for_game(game, width=64, depth=2), 0,
                        trainable=True)
    state = adam_init(net)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(6):
        state, loss = train_epoch(net, state, buf, gen,
                                  TrainConfig(batch_size=64))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
