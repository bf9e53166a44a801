"""Batched MCTS: the packed, pipelined rollout loop.

Counterpart of :mod:`alphatpu.mcts.search`, ported on the reference's
production engine only: the packed level-1 pipeline (``fused_body_packed``
and its unpack-and-flush).  Per rollout:

* :func:`~alphatpu_torch.mcts.kernels.select_apply_packed` applies the
  previous rollout's deferred writes (its leaf's prior row and its backup
  adds on the packed ``(wsum | visits)`` plane) and walks every game from
  the root to a leaf,
* the net evaluates every game's leaf in one batch,
* :func:`expand` allocates the new children and computes the leaf's prior
  row, which - with the path and the leaf value - becomes the next
  rollout's :class:`~alphatpu_torch.mcts.kernels.PendingUpdate`.

After the loop the f32 stats are rebuilt from the packed plane and the last
pending update is flushed (:func:`backup_flush`).  The tree is updated in
place throughout; the reference rebuilt its arrays.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..games.base import where_games
from .kernels import (
    PendingUpdate, backup, empty_pending, pack_stats, quantize_value,
    select_apply_packed, unpack_visits, unpack_wsum, value_scale,
)
from .newton import regularized_policy
from .tree import Tree, gather_states, scatter_states


def node_policy(prior_row, wsum_row, visits_row, cpuct):
    """Regularized policy for gathered node rows ([A, G] each), with the
    fresh-node shortcut: a node whose edges have no visits returns its
    stored prior."""
    q_row = torch.where(visits_row > 0,
                        wsum_row / torch.clamp_min(visits_row, 1.0), 0.0)
    pi = regularized_policy(prior_row, q_row, visits_row, cpuct)
    fresh = visits_row.sum(0) == 0.0
    return torch.where(fresh[None, :], prior_row, pi)


def leaf_positions(game, tree: Tree, node, leaf_action, needs_alloc):
    """Batch-layout states the net will evaluate: the stored state at an
    existing leaf, or ``play(parent_state, action)`` where a new child is
    to be allocated."""
    state = gather_states(tree.states, node)
    played = game.play(state, leaf_action)
    return where_games(needs_alloc, played, state)


def expand(game, tree: Tree, node, leaf_action, needs_alloc, leaf_states,
           prior_nn, training: bool, write_prior: bool = True):
    """Allocate the new children at ``next_idx``, mark each leaf expanded
    unless it is terminal, and compute its prior row: the net's prior
    masked to the legal moves and normalized; at the root during training
    ``0.75 * p + 0.25 * uniform`` over the legal moves (the reference's
    hard-coded exploration mix); zero on terminal leaves.

    ``prior_nn``: [A, G].  Returns ``(leaf, done, result, newp)``.  With
    ``write_prior=False`` the prior plane is left untouched and the caller
    owes the write (the rollout loop defers it into the next kernel)."""
    V = tree.num_nodes
    G = tree.num_games
    g = torch.arange(G, device=tree.device)

    new = tree.next_idx.clone()
    alloc = needs_alloc & (new < V)
    tree.parent[new.long()[alloc], g[alloc]] = node[alloc]
    tree.action_from[new.long()[alloc], g[alloc]] = leaf_action[alloc]
    scatter_states(tree.states, new, leaf_states, needs_alloc)
    tree.next_idx += needs_alloc.to(torch.int32)
    leaf = torch.where(needs_alloc, new, node)

    done, result = game.is_over(leaf_states)
    legal = game.legal_mask(leaf_states).T  # [A, G]
    p = torch.where(legal, prior_nn, 0.0)
    norm = torch.clamp_min(p.sum(0, keepdim=True), 1e-30)
    p_norm = p / norm
    if training:
        a_cnt = torch.clamp_min(
            legal.sum(0, keepdim=True).to(torch.float32), 1.0)
        mixed = 0.75 * p_norm + 0.25 / a_cnt * legal
        newp = torch.where((leaf == 0)[None, :], mixed, p_norm)
    else:
        newp = p_norm
    newp = torch.where(done[None, :], 0.0, newp)

    inside = leaf < V
    tree.expanded[leaf.long()[inside], g[inside]] = ~done[inside]
    if write_prior:
        tree.prior[:, leaf.long()[inside], g[inside]] = newp[:, inside]
    return leaf, done, result, newp


def leaf_value_of(leaf_player, value_nn, done, result):
    """The value backed up from each leaf: ``(1 + player * result) / 2`` at
    a terminal leaf, else the net's value."""
    terminal = (1.0 + leaf_player.to(torch.float32)
                * result.to(torch.float32)) / 2.0
    return torch.where(done, terminal, value_nn)


def backup_flush(tree: Tree, pend: PendingUpdate) -> None:
    """Apply a pending update's backup adds to the f32 stats, in place
    (the flush after the rollout loop; one kernel launch)."""
    backup(tree.wsum, tree.visits, pend.nodes, pend.actions, pend.length,
           pend.value)


def run_mcts(
    game,
    net: Callable,
    tree: Tree,
    *,
    rollouts: int,
    cpuct: float,
    training: bool,
    generator: torch.Generator | None = None,
    probs: torch.Tensor | None = None,
    final_root_policy: bool = False,
    segment_rollouts: bool = True,
    packed_stats: bool | int | None = None,
):
    """One search over all games from a freshly reset ``tree``:
    ``rollouts`` x (select -> batched net forward -> expand), pipelined
    through the packed stat plane, then unpack and flush.

    ``net(enc [G, in]) -> (logits [G, A], value [G])``.  ``probs``: optional
    f32[rollouts, D, G] uniforms (D = min(max_game_length, V)), one per
    rollout and depth - the reference's injection point; without it they
    are drawn from ``generator`` on the tree's device.

    Returns ``(tree, root_policy [A, G])``; ``tree`` is the argument,
    updated in place.  The root policy is the one the final rollout's walk
    computed (the reference's convention), or with ``final_root_policy``
    the policy recomputed from the final stats.

    Only the reference's production engine is ported: ``packed_stats``
    must be None, True or 1 and ``segment_rollouts`` True (the tree must be
    freshly reset - the u16 halves of the packed word bound one search's
    stats), and the stats f32.  The reference's ``vseg`` node-span
    segmentation is dropped: it bounded the TPU's HBM stream of each
    rollout and never changed a result.
    """
    if packed_stats not in (None, True, 1):
        raise ValueError(f"packed_stats={packed_stats!r}: only the packed "
                         "level-1 engine (None/True/1) is ported")
    if not segment_rollouts:
        raise ValueError("segment_rollouts=False (a pre-grown tree) is not "
                         "supported: the packed engine needs a fresh tree")
    if tree.prior.dtype != torch.float32:
        raise ValueError(f"stats of dtype {tree.prior.dtype}: only f32 "
                         "stats are supported")
    G, A, V = tree.num_games, tree.num_actions, tree.num_nodes
    dev = tree.device
    depth_cap = min(game.max_game_length, V)
    scale = value_scale(rollouts)
    if probs is not None and tuple(probs.shape) != (rollouts, depth_cap, G):
        raise ValueError(f"probs shape {tuple(probs.shape)}, expected "
                         f"{(rollouts, depth_cap, G)}")

    packed = pack_stats(tree.wsum, tree.visits, scale)
    pend = empty_pending(depth_cap, A, G, dev)
    root_pi = torch.zeros((A, G), dtype=torch.float32, device=dev)
    for r in range(rollouts):
        p = (probs[r] if probs is not None else
             torch.rand((depth_cap, G), generator=generator, device=dev))
        root_was_expanded = tree.expanded[0].clone()
        sel = select_apply_packed(
            tree.prior, packed, tree.parent, tree.action_from, tree.expanded,
            p.contiguous(), pend, cpuct, scale)
        leaf_states = leaf_positions(game, tree, sel.leaf, sel.leaf_action,
                                     sel.needs_alloc)
        with torch.no_grad():
            logits, v = net(game.encode(leaf_states))
        prior = torch.softmax(logits, dim=-1).T.contiguous()  # [A, G]
        leaf, done, result, newp = expand(
            game, tree, sel.leaf, sel.leaf_action, sel.needs_alloc,
            leaf_states, prior, training, write_prior=False)
        # a root expanded by this very rollout reports its fresh prior row
        root_pi = torch.where(root_was_expanded[None, :], sel.root_pi, newp)
        pend = PendingUpdate(
            nodes=sel.nodes,
            actions=sel.actions,
            length=(sel.nodes >= 0).sum(0, dtype=torch.int32),
            value=quantize_value(
                leaf_value_of(leaf_states.player, v, done, result), scale),
            leaf=leaf,
            newp=newp.contiguous(),
            write=torch.ones((G,), dtype=torch.bool, device=dev),
        )

    # rebuild the f32 stats from the packed plane, then flush the last
    # rollout's writes; its values are on the 1/scale grid, so the f32
    # adds equal the fixed-point adds the kernel would have made
    tree.wsum.copy_(unpack_wsum(packed, scale))
    tree.visits.copy_(unpack_visits(packed))
    w = pend.write & (pend.leaf < V)
    g = torch.arange(G, device=dev)
    tree.prior[:, pend.leaf.long()[w], g[w]] = pend.newp[:, w]
    backup_flush(tree, pend)
    if final_root_policy:
        root_pi = node_policy(tree.prior[:, 0, :], tree.wsum[:, 0, :],
                              tree.visits[:, 0, :], cpuct)
    return tree, root_pi
