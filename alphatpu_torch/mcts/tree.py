"""Tensor-resident MCTS tree storage (struct of arrays, games minor).

Counterpart of :mod:`alphatpu.mcts.tree`, in the same layout: per-node
scalars are ``[V, G]``, per-edge stats ``[A, V, G]`` and state leaves
``[V, *S, G]``, with the games axis minor.  On the card this is the layout a
one-thread-per-game kernel wants: the 32 lanes of a warp are 32 neighbouring
games and read 32 neighbouring words of any row.

The reference selects and updates nodes with one-hot masked reduces (its
hardware has no fast gather); here they are indexed gathers and scatters.
Arrays are updated in place where the reference rebuilt them:
:func:`reset_tree` refills the pool it is given.

The stat planes are f32, or bf16 under ``ALPHATPU_BF16_STATS``
(:func:`stat_dtype_for`); all policy math reads them as f32.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch


@dataclasses.dataclass
class Tree:
    parent: torch.Tensor  # i32[V, G], -1 = none
    action_from: torch.Tensor  # i32[V, G]
    expanded: torch.Tensor  # bool[V, G]
    states: Any  # game-state NamedTuple, leaves [V, *S, G]
    prior: torch.Tensor  # f32 or bf16 [A, V, G]
    wsum: torch.Tensor  # [A, V, G], prior's dtype - per-edge value sum
    visits: torch.Tensor  # [A, V, G], prior's dtype
    next_idx: torch.Tensor  # i32[G] - next free node slot

    @property
    def num_games(self) -> int:
        return self.parent.shape[-1]

    @property
    def num_nodes(self) -> int:
        return self.parent.shape[0]

    @property
    def num_actions(self) -> int:
        return self.prior.shape[0]

    @property
    def device(self) -> torch.device:
        return self.parent.device


def _to_tree_layout(batched_leaf: torch.Tensor) -> torch.Tensor:
    """[G, *S] -> [*S, G]."""
    return torch.movedim(batched_leaf, 0, -1)


def _node_major(tree_leaf: torch.Tensor) -> torch.Tensor:
    """A [V, *S, G] leaf viewed as [V, G, *S] (a view: writes land in the
    tree)."""
    return torch.movedim(tree_leaf, -1, 1)


def stat_dtype_for(rollouts: int) -> torch.dtype:
    """The storage dtype of the stat planes of a search of ``rollouts``
    nodes: bf16 when ``ALPHATPU_BF16_STATS`` is set and every stored
    visit count stays a whole number bf16 holds exactly (at most 256),
    with ``rollouts`` a multiple of 16 (the reference's bf16 tile); f32
    otherwise.  Opt-in, as in the reference: the default engine packs the
    stats instead."""
    if os.environ.get("ALPHATPU_BF16_STATS") and (
            rollouts <= 256 and rollouts % 16 == 0):
        return torch.bfloat16
    return torch.float32


def init_tree(game, positions, num_nodes: int,
              stat_dtype: torch.dtype = torch.float32) -> Tree:
    """A pool of ``num_nodes`` nodes per game with ``positions`` (leaves
    leading with G) installed as the roots, on the positions' device, with
    stat planes of ``stat_dtype`` (:func:`stat_dtype_for`)."""
    G = positions.player.shape[0]
    V = num_nodes
    A = game.max_actions
    dev = positions.player.device

    def alloc_state(leaf):
        t = _to_tree_layout(leaf)
        out = torch.zeros((V,) + tuple(t.shape), dtype=t.dtype, device=dev)
        out[0] = t
        return out

    return Tree(
        parent=torch.full((V, G), -1, dtype=torch.int32, device=dev),
        action_from=torch.zeros((V, G), dtype=torch.int32, device=dev),
        expanded=torch.zeros((V, G), dtype=torch.bool, device=dev),
        states=type(positions)(*(alloc_state(x) for x in positions)),
        prior=torch.zeros((A, V, G), dtype=stat_dtype, device=dev),
        wsum=torch.zeros((A, V, G), dtype=stat_dtype, device=dev),
        visits=torch.zeros((A, V, G), dtype=stat_dtype, device=dev),
        next_idx=torch.ones((G,), dtype=torch.int32, device=dev),
    )


def reset_tree(tree: Tree, positions) -> Tree:
    """Recycle the pool for the next move, in place: zero all stats
    (their dtype kept), install the new roots, mark everything
    unexpanded."""
    tree.parent.fill_(-1)
    tree.action_from.zero_()
    tree.expanded.zero_()
    for leaf, pos in zip(tree.states, positions):
        leaf.zero_()
        leaf[0] = _to_tree_layout(pos)
    tree.prior.zero_()
    tree.wsum.zero_()
    tree.visits.zero_()
    tree.next_idx.fill_(1)
    return tree


def child_lookup(parent, action_from, node, action) -> torch.Tensor:
    """i32[G] id of each game's child under (node, action), 0 = none.

    Every edge is allocated at most once, so at most one node v per game
    has ``parent[v] == node and action_from[v] == action``; unallocated
    slots hold parent -1 and never match."""
    V = parent.shape[0]
    match = (parent == node[None, :]) & (action_from == action[None, :])
    ids = torch.arange(V, dtype=torch.int32, device=parent.device)[:, None]
    return torch.where(match, ids, 0).sum(0, dtype=torch.int32)


def gather_states(states, node: torch.Tensor):
    """Tree states at each game's ``node``, in batch layout [G, *S]."""
    g = torch.arange(node.shape[0], device=node.device)
    return type(states)(*(_node_major(leaf)[node.long(), g] for leaf in states))


def write_where(plane: torch.Tensor, row: torch.Tensor, mask: torch.Tensor,
                value: torch.Tensor) -> None:
    """``plane[row[g], g] = value[g]`` where ``mask[g]``, in place, in one
    fixed-shape write: ``plane`` is [N, G, ...] (a view writes through),
    ``row`` [G] and ``value`` [G, ...].  Every game writes its own column
    at ``clamp(row, 0, N - 1)``; a masked lane writes back the value that
    is there, so the result equals the masked write bit for bit and no
    shape depends on the mask (nothing waits for the device).  The caller
    masks the rows outside ``[0, N)``."""
    g = torch.arange(row.shape[0], device=row.device)
    r = torch.clamp(row.long(), 0, plane.shape[0] - 1)
    old = plane[r, g]
    keep = mask.reshape(mask.shape + (1,) * (old.dim() - 1))
    plane[r, g] = torch.where(keep, value.to(plane.dtype), old)


def scatter_states(states, node: torch.Tensor, new_states, mask: torch.Tensor):
    """Write batch-layout states [G, *S] into the tree at each game's
    ``node`` where ``mask`` (and ``node < V``) holds, in place."""
    sel = mask & (node < states[0].shape[0])
    for leaf, new in zip(states, new_states):
        write_where(_node_major(leaf), node, sel, new)
