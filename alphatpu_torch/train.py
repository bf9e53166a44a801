"""Learner: the loss, the optimizer and one epoch of SGD over the buffer.

Counterpart of :mod:`alphatpu.train`:

* loss = soft-target cross-entropy(policy logits, pi) + MSE(value, z)
  + ``feature_weight`` x MSE(feature, final state), the feature MSE a mean
  over every element of ``[B, fsize]``,
* the optimizer is the reference's optax chain ``scale_by_adam -> scale(lr)
  -> add_decayed_weights(wd) -> scale(-1)``, written out by hand because
  neither ``torch.optim.Adam`` nor ``AdamW`` computes it: the step is
  ``p -= lr * mu_hat / (sqrt(nu_hat) + eps) + wd * p``, the decay not
  scaled by lr and applied to every parameter, biases included,
* an epoch runs ``max(nsamples // batch - 1, 1)`` updates on batches drawn
  uniformly with replacement, ``nsamples = min(size, max_samples)``,
* in a world of D ranks (alphatpu/train.py:74-100, the ``axis_name``
  path) each rank draws ``batch_size`` rows from its own buffer shard with
  its own stream, ``nsamples`` is the sum over the shards and the global
  batch ``batch_size * D``, so every rank runs the same updates; the
  gradients and the loss are averaged over the ranks (the reference's
  ``pmean``) by one all_reduce of the flattened bucket per update, and the
  replicated parameters stay equal bit for bit.  The net is no DDP module:
  the epoch takes ``torch.autograd.grad`` and the hand-written Adam step.

The optimizer state is ``{"count": i32 0-d, "mu": {name: tensor}, "nu":
{name: tensor}}``, the fields of optax's ``ScaleByAdamState``, so that a
checkpoint writes it under the reference's keys.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from .buffer import ReplayBuffer, global_buffer_size, sample_batch
from .nets.mlp import MLP, PARAM_NAMES
from .parallel.mesh import all_reduce, world_size

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam's defaults (eps_root 0)


class TrainConfig(NamedTuple):
    batch_size: int = 8192
    lr: float = 1e-3
    weight_decay: float = 1e-4
    feature_weight: float = 1e-3
    epochs: int = 1
    max_samples: int = 2_000_000


def loss_fn(net: MLP, state, pi_target, z, fstate, feature_weight: float):
    """The training loss of one batch (a 0-d tensor)."""
    logits, v, f = net.forward_training(state)
    ce = -torch.mean(torch.sum(pi_target * torch.log_softmax(logits, -1), -1))
    mse_v = torch.mean((v - z) ** 2)
    mse_f = torch.mean((f - fstate) ** 2)
    return ce + mse_v + feature_weight * mse_f


def adam_init(net: MLP) -> Dict:
    """A fresh optimizer state for ``net``'s parameters."""
    dev = net.base.device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": {n: torch.zeros_like(getattr(net, n).detach())
               for n in PARAM_NAMES},
        "nu": {n: torch.zeros_like(getattr(net, n).detach())
               for n in PARAM_NAMES},
    }


@torch.no_grad()
def adam_update(net: MLP, grads: Dict[str, torch.Tensor], opt_state: Dict,
                cfg: TrainConfig) -> Dict:
    """One step of the reference's chain on ``net``'s parameters, in
    place, from ``grads`` ({name: tensor}).  Returns the new state."""
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32, device=cf.device) ** cf
    bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32, device=cf.device) ** cf
    mu, nu = {}, {}
    for name in PARAM_NAMES:
        p, g = getattr(net, name), grads[name]
        mu[name] = (1.0 - B1) * g + B1 * opt_state["mu"][name]
        nu[name] = (1.0 - B2) * (g * g) + B2 * opt_state["nu"][name]
        step = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + EPS)
        p.sub_(cfg.lr * step + cfg.weight_decay * p)
    return {"count": count, "mu": mu, "nu": nu}


def mean_over_ranks(tensors: Sequence[torch.Tensor]) -> list:
    """Each tensor averaged over the ranks: one all_reduce of them all,
    flattened into one bucket, divided by the world size."""
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    flat = flat / world_size()
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


def train_epoch(net: MLP, opt_state: Dict, buffer: ReplayBuffer,
                generator: torch.Generator | None, cfg: TrainConfig,
                indices: Sequence[torch.Tensor] | None = None):
    """One epoch of SGD over the buffer: ``net`` (trainable) is updated in
    place.  ``indices[i]`` (i64[B]) replaces update i's draw.  Returns
    ``(opt_state, loss)`` with the mean loss of the updates (a 0-d
    tensor).  In a world of several ranks every rank calls it, with its
    own shard, stream and per-rank ``cfg.batch_size``."""
    D = world_size()
    nsamples = min(global_buffer_size(buffer), cfg.max_samples)
    n_updates = max(nsamples // (cfg.batch_size * D) - 1, 1)
    params = [getattr(net, n) for n in PARAM_NAMES]
    loss_acc = torch.zeros((), dtype=torch.float32, device=net.base.device)
    for i in range(n_updates):
        state, pi, z, fstate = sample_batch(
            buffer, generator, cfg.batch_size,
            None if indices is None else indices[i])
        loss = loss_fn(net, state, pi, z, fstate, cfg.feature_weight)
        grads = torch.autograd.grad(loss, params)
        if D > 1:
            *grads, loss = mean_over_ranks([*grads, loss.detach()])
        opt_state = adam_update(net, dict(zip(PARAM_NAMES, grads)), opt_state,
                                cfg)
        loss_acc = loss_acc + loss.detach()
    return opt_state, loss_acc / n_updates
