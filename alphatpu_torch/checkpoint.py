"""Checkpoint / resume: both nets, the optimizer state, Elo, the random
stream and (optionally) the replay buffer and the selfplay carry, per
generation.

Counterpart of :mod:`alphatpu.checkpoint`, with its files and keys:
``net{index}.npz`` (the index wraps at 1000) holding ``best/<name>``,
``train/<name>``, ``opt/0/.count``, ``opt/0/.mu/<name>``,
``opt/0/.nu/<name>`` and ``rng``; ``buffer.npz`` holding ``.state``,
``.policy``, ``.player``, ``.value``, ``.fstate``, ``.cursor`` and
``.total``; ``carry.npz`` holding the :class:`EpisodeCarry` fields
(``.positions/.<field>``, ``.count``, ``.enc``, ``.pol``, ``.player``,
``.rng``); and the manifest ``latest.json``.  Either package reads the
other's nets, optimizer state and buffer.  Bitboard words are written as
uint32, the reference's dtype.

``rng`` and the carry's ``.rng`` are this package's own ``torch.Generator``
states as uint8 arrays.  They are not interchangeable with the
reference's JAX keys: a run resumed in the other package continues its
nets and buffer, but draws another random stream.

A world of D ranks writes the reference's sharded layout: rank 0 writes
what :func:`gather_buffer` and :func:`gather_carry` collect from every
rank - the buffer rows shard-major with ``.cursor`` and ``.total`` of shape
``(D,)``, the carry's leaves on the games axis (rank-major) and its
``.rng`` one generator state per rank, ``(D, n)``.  ``load_checkpoint``
with ``world`` gives each rank its shard, and refuses a checkpoint of
another D.  A sharded checkpoint of either package loads into the other
at the same D.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .buffer import ReplayBuffer
from .nets.mlp import MLP, PARAM_NAMES, params_from_jax, params_to_numpy
from .parallel.mesh import World, all_gather, world_size
from .selfplay import EpisodeCarry

_BUFFER_FIELDS = ("state", "policy", "player", "value", "fstate", "cursor",
                  "total")
_CARRY_FIELDS = ("count", "enc", "pol", "player")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as the reference stores it: bitboard words (int64 here)
    as uint32."""
    arr = t.detach().cpu().numpy()
    return arr.astype(np.uint32) if arr.dtype == np.int64 else arr


def _like(arr: np.ndarray, template: torch.Tensor) -> torch.Tensor:
    """``arr`` with the dtype, shape and device of ``template``."""
    out = torch.from_numpy(np.asarray(arr).astype(np.int64)
                           if template.dtype == torch.int64 else
                           np.asarray(arr))
    if tuple(out.shape) != tuple(template.shape):
        raise ValueError(f"shape {tuple(out.shape)}, expected "
                         f"{tuple(template.shape)}")
    return out.to(dtype=template.dtype, device=template.device)


def restore_generator(state: np.ndarray, device) -> torch.Generator | None:
    """The generator whose state this package wrote; None for the
    reference's JAX key data (uint32), which no generator can take."""
    if state.dtype != np.uint8:
        return None
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(state))
    return gen


def _generator_state(rng) -> np.ndarray:
    """A carry's ``rng`` as written: a generator's state, or the stacked
    states of a gathered carry."""
    return (rng if isinstance(rng, torch.Tensor) else rng.get_state()).numpy()


def gather_buffer(buffer: ReplayBuffer) -> ReplayBuffer:
    """Every rank's buffer shard in one buffer of the reference's sharded
    layout: rows shard-major, ``cursor`` and ``total`` of shape ``(D,)``.
    A collective: every rank calls it (in a world of one it returns
    ``buffer``)."""
    if world_size() == 1:
        return buffer
    return ReplayBuffer(**{f: torch.cat(all_gather(getattr(buffer, f)))
                           for f in _BUFFER_FIELDS})


def gather_carry(carry: EpisodeCarry) -> EpisodeCarry:
    """Every rank's carry in one, its leaves on the games axis rank-major
    and ``rng`` the ranks' generator states stacked (uint8 ``[D, n]``).  A
    collective, as :func:`gather_buffer`."""
    if world_size() == 1:
        return carry
    pos = carry.positions
    return EpisodeCarry(
        positions=type(pos)(*(torch.cat(all_gather(x)) for x in pos)),
        **{f: torch.cat(all_gather(getattr(carry, f)))
           for f in _CARRY_FIELDS},
        rng=torch.stack(all_gather(carry.rng.get_state())))


def _opt_flat(opt_state: Dict) -> Dict[str, np.ndarray]:
    flat = {"opt/0/.count": _to_numpy(opt_state["count"])}
    for field in ("mu", "nu"):
        for name in PARAM_NAMES:
            flat[f"opt/0/.{field}/{name}"] = _to_numpy(opt_state[field][name])
    return flat


def save_checkpoint(ckpt_dir: str, generation: int, *, best_net: MLP,
                    train_net: MLP, opt_state: Dict, elo: float,
                    best_generation: int, rng: torch.Generator,
                    buffer: ReplayBuffer | None = None,
                    sp_carry: EpisodeCarry | None = None) -> str:
    """Write generation ``generation``'s checkpoint; returns the net
    file's path.  ``sp_carry`` (continuous selfplay) makes a resume exact:
    in-flight episodes continue instead of restarting."""
    os.makedirs(ckpt_dir, exist_ok=True)
    index = (generation - 1) % 1000 + 1
    base = os.path.join(ckpt_dir, f"net{index}")
    np.savez_compressed(base + ".npz", **{
        **params_to_numpy(best_net, "best/"),
        **params_to_numpy(train_net, "train/"),
        **_opt_flat(opt_state),
        "rng": rng.get_state().numpy(),
    })
    if buffer is not None:
        np.savez_compressed(
            os.path.join(ckpt_dir, "buffer.npz"),
            **{"." + f: _to_numpy(getattr(buffer, f)) for f in _BUFFER_FIELDS})
    if sp_carry is not None:
        flat = {f".positions/.{f}": _to_numpy(x)
                for f, x in zip(sp_carry.positions._fields, sp_carry.positions)}
        flat.update({"." + f: _to_numpy(getattr(sp_carry, f))
                     for f in _CARRY_FIELDS})
        flat[".rng"] = _generator_state(sp_carry.rng)
        np.savez_compressed(os.path.join(ckpt_dir, "carry.npz"), **flat)
    manifest = {
        "generation": generation,
        "index": index,
        "elo": float(elo),
        "best_generation": int(best_generation),
        "has_buffer": buffer is not None,
        "has_carry": sp_carry is not None,
    }
    with open(os.path.join(ckpt_dir, "latest.json"), "w") as f:
        json.dump(manifest, f)
    return base + ".npz"


def _shard_of(arr: np.ndarray, template: torch.Tensor, world: World,
              what: str) -> torch.Tensor:
    """Rank ``world.rank``'s rows of ``arr``, which holds ``world.size``
    shards of ``template``'s rows."""
    n = template.shape[0]
    if arr.shape[0] != n * world.size:
        raise ValueError(f"{what}: {arr.shape[0]} rows, expected "
                         f"{world.size} shards of {n}")
    return _like(arr[world.rank * n:(world.rank + 1) * n], template)


def _load_buffer(z, buffer: ReplayBuffer, world: World) -> ReplayBuffer:
    shards = z[".cursor"].shape[0]
    if shards != world.size:
        raise ValueError(f"the checkpoint's buffer has {shards} shard(s), "
                         f"this run {world.size}: resume with --devices "
                         f"{shards}")
    return ReplayBuffer(**{f: _shard_of(z["." + f], getattr(buffer, f), world,
                                        "buffer." + f)
                           for f in _BUFFER_FIELDS})


def _load_carry(z, carry: EpisodeCarry, world: World) -> EpisodeCarry:
    pos = carry.positions
    rng = z[".rng"]
    if world.size > 1:
        rng = rng[world.rank] if rng.ndim == 2 else np.zeros(0, np.uint32)
    return EpisodeCarry(
        positions=type(pos)(*(
            _shard_of(z[f".positions/.{f}"], x, world, "carry." + f)
            for f, x in zip(pos._fields, pos))),
        **{f: _shard_of(z["." + f], getattr(carry, f), world, "carry." + f)
           for f in _CARRY_FIELDS},
        rng=restore_generator(rng, carry.count.device))


def load_checkpoint(ckpt_dir: str, *, best_net: MLP, train_net: MLP,
                    opt_state: Dict, buffer: ReplayBuffer | None = None,
                    sp_carry: EpisodeCarry | None = None,
                    world: World | None = None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read the latest checkpoint; the arguments are templates that give
    the structure, dtypes, devices and trainability, and are not changed.
    Returns ``(manifest, state)`` with the keys ``best``, ``train``,
    ``opt`` and ``rng`` (a generator on the nets' device, None in a
    checkpoint of the reference), and ``buffer`` and ``sp_carry`` where a
    template was given and the checkpoint has them (the carry's ``rng``
    None as ``rng``).  With ``world`` (rank r of D) the buffer and the
    carry are shard r of a checkpoint of D shards, and the templates are
    one shard's; a buffer of another number of shards raises."""
    world = world or World(0, 1, best_net.base.device)
    with open(os.path.join(ckpt_dir, "latest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, f"net{manifest['index']}.npz")) as z:
        flat = dict(z)
    dev = best_net.base.device
    state = {
        "best": params_from_jax(flat, best_net.cfg, dev, "best/",
                                best_net.base.requires_grad),
        "train": params_from_jax(flat, train_net.cfg, dev, "train/",
                                 train_net.base.requires_grad),
        "opt": {
            "count": _like(flat["opt/0/.count"], opt_state["count"]),
            **{field: {n: _like(flat[f"opt/0/.{field}/{n}"],
                                opt_state[field][n]) for n in PARAM_NAMES}
               for field in ("mu", "nu")},
        },
        "rng": restore_generator(flat["rng"], dev),
    }
    if buffer is not None and manifest.get("has_buffer"):
        with np.load(os.path.join(ckpt_dir, "buffer.npz")) as z:
            state["buffer"] = _load_buffer(z, buffer, world)
    if sp_carry is not None and manifest.get("has_carry"):
        with np.load(os.path.join(ckpt_dir, "carry.npz")) as z:
            state["sp_carry"] = _load_carry(z, sp_carry, world)
    return manifest, state
