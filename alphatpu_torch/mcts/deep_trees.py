"""Deep, narrow search trees without a trained net.

A trained net's prior is sharp, so its search follows few edges far down:
gobang13's generation-56 net walks 38.5% longer a launch than a net from a
seed, whose flat prior grows shallow, broad trees from the initial
position.  These helpers grow trees like the trained net's from a seed
alone: a net whose policy head is scaled up (:func:`sharpen`) searching
mid-game positions made by random legal plies (:func:`opening_positions`).
:func:`node_depths` measures what they reach.
"""
from __future__ import annotations

import numpy as np
import torch


def sharpen(net, factor: float):
    """``net`` (an :class:`~alphatpu_torch.nets.MLP`) with its policy head's
    weights and bias multiplied by ``factor``, in place: its logits scale
    by ``factor`` and its prior sharpens.  Returns ``net``."""
    with torch.no_grad():
        net.policy_w.mul_(factor)
        net.policy_b.mul_(factor)
    return net


def opening_positions(game, G: int, plies: int, seed: int, device=None):
    """``G`` positions after ``plies`` random legal moves each, drawn with
    numpy from ``seed``, and the actions ``int32[plies, G]`` that made them.
    Made on the CPU, returned on ``device``."""
    rng = np.random.default_rng(seed)
    pos = game.initial(G)
    actions = np.zeros((plies, G), np.int32)
    for k in range(plies):
        legal = game.legal_mask(pos).numpy()
        actions[k] = np.where(legal, rng.random(legal.shape), -1.0).argmax(1)
        pos = game.play(pos, torch.from_numpy(actions[k]))
    if device is not None:
        pos = type(pos)(*(x.to(device) for x in pos))
    return pos, actions


def node_depths(parent) -> np.ndarray:
    """int64[V, G]: each node's edges from the root (0 for the root and for
    nodes not allocated), from ``tree.parent`` i32[V, G]."""
    parent = np.asarray(parent.cpu() if isinstance(parent, torch.Tensor)
                        else parent)
    V, G = parent.shape
    depth = np.zeros((V, G), np.int64)
    lanes = np.arange(G)
    for v in range(1, V):  # a child is allocated after its parent
        p = parent[v]
        depth[v] = np.where(p >= 0, depth[np.maximum(p, 0), lanes] + 1, 0)
    return depth
