"""The sharded executors: selfplay, the learner and the duel over a world
of D ranks.

Counterpart of ``sharded_selfplay_fn``, ``sharded_train_fn``,
``sharded_duel_fn`` and ``sharded_duel_network``
(alphatpu/parallel/mesh.py:65-187), with their names and return
contracts.  Every rank calls each executor with the same replicated nets;
it plays ``1/D`` of the games on its own device with its own random
stream, writes its own buffer shard, and the executor sums what the
reference ``psum``s.  No collective runs during a search: the ranks meet
once per call, to sum the stats or the tally.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..duel import DuelConfig, duel_half
from ..selfplay import (
    SelfplayConfig, SelfplayUniforms, selfplay_continuous,
    selfplay_generation,
)
from ..train import TrainConfig, train_epoch
from .mesh import World, all_reduce, psum_stats, rank_generator


def _split(total: int, world: World, what: str) -> int:
    if total % world.size:
        raise ValueError(f"{what} ({total}) must divide the mesh size "
                         f"{world.size}")
    return total // world.size


def sharded_selfplay_fn(game, net_apply, cfg: SelfplayConfig, world: World):
    """Selfplay with ``cfg.num_games / D`` lanes on each rank.

    One-shot mode: ``run(net, buffer, generator, uniforms=None) ->
    (buffer, stats)``; continuous mode threads the rank's
    :class:`~alphatpu_torch.selfplay.EpisodeCarry`, whose generator is
    replaced by ``generator`` each call (the reference refreshes the
    carry's key from the device's key): ``run(net, buffer, generator,
    carry, uniforms=None) -> (buffer, stats, carry)``.  ``net`` goes to
    ``net_apply``; ``buffer`` is the rank's shard, ``generator`` its
    stream (``rank_generator``), ``uniforms`` replaces its draws; ``stats``
    are summed over the ranks."""
    local = cfg._replace(num_games=_split(cfg.num_games, world, "num_games"))

    if not cfg.continuous:
        def run(net, buffer, generator: torch.Generator | None,
                uniforms: SelfplayUniforms | None = None):
            buffer, stats = selfplay_generation(
                game, partial(net_apply, net), buffer, generator, local,
                uniforms)
            return buffer, psum_stats(stats)

        return run

    def run_cont(net, buffer, generator: torch.Generator | None, carry,
                 uniforms: SelfplayUniforms | None = None):
        buffer, stats, carry = selfplay_continuous(
            game, partial(net_apply, net), buffer, None, local,
            dataclasses.replace(carry, rng=generator), uniforms)
        return buffer, psum_stats(stats), carry

    return run_cont


def sharded_train_fn(game, cfg: TrainConfig, world: World):
    """The data-parallel learner: ``run(net, opt_state, buffer, generator,
    indices=None) -> (opt_state, loss)`` with ``cfg.batch_size`` the global
    batch, ``batch_size / D`` drawn by each rank from its shard with its
    own ``generator`` (or taken from its ``indices``); the gradients and
    the loss are averaged over the ranks (``train_epoch``)."""
    local = cfg._replace(batch_size=_split(cfg.batch_size, world,
                                           "batch_size"))

    def run(net, opt_state, buffer, generator, indices=None):
        return train_epoch(net, opt_state, buffer, generator, local, indices)

    return run


def sharded_duel_fn(game, net_apply, cfg: DuelConfig, world: World):
    """``run(net_first, net_second, generator, uniforms=None) -> (w, d, l,
    unfinished)``: ``cfg.num_games / D`` games with ``net_first`` moving
    first on each rank, from the rank's ``generator``; the four counts are
    summed over the ranks (0-d tensors)."""
    local = cfg._replace(num_games=_split(cfg.num_games, world, "num_games"))

    def run(net_first, net_second, generator: torch.Generator | None,
            uniforms: SelfplayUniforms | None = None):
        tally = duel_half(game, partial(net_apply, net_first),
                          partial(net_apply, net_second), generator, local,
                          world.device, uniforms)
        return tuple(all_reduce(torch.stack(tally)))

    return run


def sharded_duel_network(game, net_apply, cfg: DuelConfig, world: World):
    """The gating duel with its games over the ranks, half the games with
    each starter: ``duel(net_a, net_b, generator) -> (wins_a, draws,
    wins_b, unfinished)`` host ints.  ``generator`` is the shared stream:
    each half draws the ranks' streams from it."""
    run = sharded_duel_fn(game, net_apply,
                          cfg._replace(num_games=cfg.num_games // 2), world)

    def duel(net_a, net_b, generator: torch.Generator):
        wa1, d1, wb1, u1 = run(net_a, net_b, rank_generator(generator, world))
        wb2, d2, wa2, u2 = run(net_b, net_a, rank_generator(generator, world))
        return (int(wa1 + wa2), int(d1 + d2), int(wb1 + wb2), int(u1 + u2))

    return duel
