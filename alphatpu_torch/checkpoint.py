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
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .buffer import ReplayBuffer
from .nets.mlp import MLP, PARAM_NAMES, params_from_jax, params_to_numpy
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
        flat[".rng"] = sp_carry.rng.get_state().numpy()
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


def load_checkpoint(ckpt_dir: str, *, best_net: MLP, train_net: MLP,
                    opt_state: Dict, buffer: ReplayBuffer | None = None,
                    sp_carry: EpisodeCarry | None = None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read the latest checkpoint; the arguments are templates that give
    the structure, dtypes, devices and trainability, and are not changed.
    Returns ``(manifest, state)`` with the keys ``best``, ``train``,
    ``opt`` and ``rng`` (a generator on the nets' device, None in a
    checkpoint of the reference), and ``buffer`` and ``sp_carry`` where a
    template was given and the checkpoint has them (the carry's ``rng``
    None as ``rng``)."""
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
            state["buffer"] = ReplayBuffer(**{
                f: _like(z["." + f], getattr(buffer, f))
                for f in _BUFFER_FIELDS})
    if sp_carry is not None and manifest.get("has_carry"):
        with np.load(os.path.join(ckpt_dir, "carry.npz")) as z:
            pos = sp_carry.positions
            state["sp_carry"] = EpisodeCarry(
                positions=type(pos)(*(
                    _like(z[f".positions/.{f}"], x)
                    for f, x in zip(pos._fields, pos))),
                **{f: _like(z["." + f], getattr(sp_carry, f))
                   for f in _CARRY_FIELDS},
                rng=restore_generator(z[".rng"], sp_carry.count.device))
    return manifest, state
