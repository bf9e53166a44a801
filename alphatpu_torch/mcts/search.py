"""Batched MCTS: the per-phase search and the pipelined rollout loop.

Counterpart of :mod:`alphatpu.mcts.search`.  Two ways to search:

* the per-phase API of the reference - :func:`select` (the read-only walk,
  the ``select`` kernel; :func:`descend` is its plain version),
  :func:`leaf_positions`, :func:`expand` and :func:`backup` (the
  ``backup`` kernel) - one rollout at a time, the stats written at once;
* :func:`run_mcts`, the pipelined rollout loop with three engines, as in
  the reference (search.py:474-505).  Per rollout one select_apply kernel
  applies the previous rollout's deferred writes (its leaf's prior row and
  its backup adds) and walks every game from the root to a leaf; the net
  evaluates every game's leaf in one batch; :func:`expand` allocates the
  new children and computes the leaf's prior row, which - with the path
  and the leaf value - becomes the next rollout's
  :class:`~alphatpu_torch.mcts.kernels.PendingUpdate`.  After the loop
  the f32 stats are rebuilt from the engine's plane and the last pending
  update is flushed (:func:`backup_flush`).

The engines (:func:`engine_level`):

* level 1, the default: ``select_apply_packed`` on the packed ``(wsum |
  visits)`` plane, leaf values on the 1/value_scale(R) grid,
* level 2 (``packed_stats=2`` or ``ALPHATPU_PACK=2``):
  ``select_apply_packed1`` on the 1-plane ``(prior | wsum | visits)``
  word, leaf values on the 1/S1 grid and prior rows on the 1/2048 grid,
* level 0, f32 (``packed_stats=False``, ``ALPHATPU_NO_PACK=1``, or a
  pre-grown tree, ``segment_rollouts=False``): ``select_apply`` on three
  f32 planes, values unquantized.

A tree of bf16 stat planes (``ALPHATPU_BF16_STATS``,
:func:`~alphatpu_torch.mcts.tree.stat_dtype_for`) always runs level 0, on
the bf16 instantiations of ``select_apply`` and ``backup``; a level asked
for is ignored, as in the reference.  Every policy reads the rows as f32,
and a stored value is rounded once to bf16 where the reference rounds it:
at each backup add and at each prior-row write.

The tree is updated in place throughout; the reference rebuilt its arrays.
Every write is fixed-shape (``tree.write_where``) and nothing in
:func:`run_mcts` waits for the device, so a round that searches can be
captured as one CUDA graph (:mod:`alphatpu_torch.graphs`).
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple

import torch

from ..games.base import where_games
from . import kernels as K
from .newton import regularized_policy
from .tree import Tree, gather_states, scatter_states, write_where


def node_policy(prior_row, wsum_row, visits_row, cpuct):
    """Regularized policy for gathered node rows ([A, G] each, read as
    f32), with the fresh-node shortcut: a node whose edges have no visits
    returns its stored prior."""
    prior_row, wsum_row, visits_row = (
        x.float() for x in (prior_row, wsum_row, visits_row))
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

    ``prior_nn``: [A, G].  Returns ``(leaf, done, result, newp)``, newp
    in f32; the row written into the tree is rounded to the prior plane's
    dtype.  With ``write_prior=False`` the prior plane is left untouched
    and the caller owes the write (the rollout loop defers it into the
    next kernel)."""
    V = tree.num_nodes

    new = tree.next_idx.clone()
    alloc = needs_alloc & (new < V)
    write_where(tree.parent, new, alloc, node)
    write_where(tree.action_from, new, alloc, leaf_action)
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
    write_where(tree.expanded, leaf, inside, ~done)
    if write_prior:
        write_where(_node_rows(tree.prior), leaf, inside, newp.T)
    return leaf, done, result, newp


def _node_rows(plane: torch.Tensor) -> torch.Tensor:
    """A stat plane [A, V, G] viewed as [V, G, A] (writes land in it)."""
    return plane.permute(1, 2, 0)


def leaf_value_of(leaf_player, value_nn, done, result):
    """The value backed up from each leaf: ``(1 + player * result) / 2`` at
    a terminal leaf, else the net's value."""
    terminal = (1.0 + leaf_player.to(torch.float32)
                * result.to(torch.float32)) / 2.0
    return torch.where(done, terminal, value_nn)


class Path(NamedTuple):
    """Edges traversed in one rollout: entry d is the edge taken at depth
    d (node -1 = the game recorded nothing at that depth)."""

    nodes: torch.Tensor  # i32[D, G]
    actions: torch.Tensor  # i32[D, G]
    length: torch.Tensor  # i32[G] - number of recorded edges


def _walk_result(sel: K.Selection):
    path = Path(sel.nodes, sel.actions,
                (sel.nodes >= 0).sum(0, dtype=torch.int32))
    return path, sel.leaf, sel.leaf_action, sel.needs_alloc, sel.root_pi


def descend(game, tree: Tree, probs, cpuct):
    """Walk every game from its root to a leaf, computing each node's
    regularized policy on the fly; read-only over the tree.  The plain
    torch version of :func:`select`'s kernel.

    ``probs``: f32[D, G] uniforms, one per depth.  Returns ``(path, node,
    leaf_action, needs_alloc, root_pi)``: lanes with ``needs_alloc`` sampled
    an edge with no child yet (``node`` is its parent); the others stopped
    at the unexpanded node ``node``; ``root_pi`` [A, G] is the depth-0
    policy."""
    return _walk_result(K.select_plain(
        tree.prior, tree.wsum, tree.visits, tree.parent, tree.action_from,
        tree.expanded, probs, cpuct))


def select(game, tree: Tree, probs, cpuct):
    """One rollout's walk, as :func:`descend` returns it: the ``select``
    kernel on a tree on the card, :func:`descend` on a tree on the CPU."""
    return _walk_result(K.select(
        tree.prior, tree.wsum, tree.visits, tree.parent, tree.action_from,
        tree.expanded, probs.contiguous(), cpuct))


def backup(tree: Tree, path: Path, leaf_player, value_nn, done, result,
           value_scale: int | None = None) -> Tree:
    """Back up every game's leaf value along its recorded path, in place:
    per edge wsum += the parity-flipped value, visits += 1 (the ``backup``
    kernel).  ``value_scale`` first rounds the value to the 1/value_scale
    grid, as the level-1 engine stores it.  Returns ``tree``."""
    leaf_value = leaf_value_of(leaf_player, value_nn, done, result)
    if value_scale is not None:
        leaf_value = K.quantize_value(leaf_value, value_scale)
    K.backup(tree.wsum, tree.visits, path.nodes, path.actions, path.length,
             leaf_value)
    return tree


def backup_flush(tree: Tree, pend: K.PendingUpdate) -> None:
    """Apply a pending update's backup adds to the stats, in place (the
    flush after the rollout loop; one kernel launch)."""
    K.backup(tree.wsum, tree.visits, pend.nodes, pend.actions, pend.length,
             pend.value)


def engine_level(packed_stats, segment_rollouts: bool,
                 stat_dtype: torch.dtype = torch.float32) -> int:
    """The engine ``run_mcts`` runs: 0 (three planes), 1 (packed) or 2
    (1-plane).

    ``packed_stats=None`` picks ``ALPHATPU_PACK`` (default 1) on a fresh
    tree, and level 0 under ``ALPHATPU_NO_PACK`` or on a pre-grown tree
    (``segment_rollouts=False``); both switches are read at each call.  An
    explicit level >= 1 on a pre-grown tree raises: the packed fields bound
    one fresh search's stats only.  bf16 stats (``stat_dtype``) always run
    level 0: the packed planes are an f32-storage design, so the switches
    and an explicit level on a fresh tree are ignored there."""
    bf16 = stat_dtype == torch.bfloat16
    if packed_stats is None:
        if not segment_rollouts or os.environ.get("ALPHATPU_NO_PACK") or bf16:
            return 0
        level = int(os.environ.get("ALPHATPU_PACK") or 1)
    else:
        level = int(packed_stats)
        if level and not segment_rollouts:
            raise ValueError(
                f"packed_stats={packed_stats!r} requires a freshly reset tree "
                "(segment_rollouts=True): the packed fields bound a single "
                "search's visits and wsum only.  Search a pre-grown tree "
                "with packed_stats=False (the f32 engine).")
        if bf16:
            return 0
    if level not in (0, 1, 2):
        raise ValueError(f"stat engine level {level}: expected 0, 1 or 2")
    return level


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
    """One search over all games: ``rollouts`` x (select -> batched net
    forward -> expand), pipelined through the engine's stat plane, then
    unpack and flush.

    ``net(enc [G, in]) -> (logits [G, A], value [G])``.  ``probs``: optional
    f32[rollouts, D, G] uniforms (D = min(max_game_length, V)), one per
    rollout and depth - the reference's injection point; without it they
    are drawn from ``generator`` on the tree's device.

    Returns ``(tree, root_policy [A, G])``; ``tree`` is the argument,
    updated in place.  The root policy is the one the final rollout's walk
    computed (the reference's convention), or with ``final_root_policy``
    the policy recomputed from the final stats.

    ``segment_rollouts=False`` declares a pre-grown tree, and
    ``packed_stats`` picks the engine (:func:`engine_level`).  The three
    stat planes must be all f32 or all bf16 (bf16: level 0 always).  The
    reference's ``vseg`` node-span segmentation is dropped: it bounded the
    TPU's HBM stream of each rollout and never changed a result.
    """
    level = engine_level(packed_stats, segment_rollouts, K.stat_dtype(
        "run_mcts", tree.prior, tree.wsum, tree.visits))
    G, A, V = tree.num_games, tree.num_actions, tree.num_nodes
    dev = tree.device
    depth_cap = min(game.max_game_length, V)
    if probs is not None and tuple(probs.shape) != (rollouts, depth_cap, G):
        raise ValueError(f"probs shape {tuple(probs.shape)}, expected "
                         f"{(rollouts, depth_cap, G)}")
    walk_args = (tree.parent, tree.action_from, tree.expanded)

    if level == 2:
        layout = K.packed1_layout(rollouts)
        if rollouts * layout.scale >= 1 << layout.bits_w:
            raise ValueError(f"rollouts={rollouts}: one search's wsum does "
                             "not fit the 1-plane word")
        scale = layout.scale
        plane = K.pack1_stats(tree.prior, tree.wsum, tree.visits, layout)

        def walk(p, pend):
            return K.select_apply_packed1(plane, *walk_args, p, pend, cpuct,
                                          layout)
    elif level == 1:
        scale = K.value_scale(rollouts)
        plane = K.pack_stats(tree.wsum, tree.visits, scale)

        def walk(p, pend):
            return K.select_apply_packed(tree.prior, plane, *walk_args, p,
                                         pend, cpuct, scale)
    else:
        scale = None  # f32: values are backed up unquantized

        def walk(p, pend):
            return K.select_apply(tree.prior, tree.wsum, tree.visits,
                                  *walk_args, p, pend, cpuct)

    pend = K.empty_pending(depth_cap, A, G, dev)
    root_pi = torch.zeros((A, G), dtype=torch.float32, device=dev)
    for r in range(rollouts):
        p = (probs[r] if probs is not None else
             torch.rand((depth_cap, G), generator=generator, device=dev))
        root_was_expanded = tree.expanded[0].clone()
        sel = walk(p.contiguous(), pend)
        leaf_states = leaf_positions(game, tree, sel.leaf, sel.leaf_action,
                                     sel.needs_alloc)
        with torch.no_grad():
            logits, v = net(game.encode(leaf_states))
        prior = torch.softmax(logits, dim=-1).T.contiguous()  # [A, G]
        leaf, done, result, newp = expand(
            game, tree, sel.leaf, sel.leaf_action, sel.needs_alloc,
            leaf_states, prior, training, write_prior=False)
        # a root expanded by this very rollout reports its fresh prior row
        # (unquantized at every level)
        root_pi = torch.where(root_was_expanded[None, :], sel.root_pi, newp)
        value = leaf_value_of(leaf_states.player, v, done, result)
        pend = K.PendingUpdate(
            nodes=sel.nodes,
            actions=sel.actions,
            length=(sel.nodes >= 0).sum(0, dtype=torch.int32),
            value=value if scale is None else K.quantize_value(value, scale),
            leaf=leaf,
            newp=newp.contiguous(),
            write=torch.ones((G,), dtype=torch.bool, device=dev),
        )

    # rebuild the f32 stats from the packed plane, then flush the last
    # rollout's writes; packed values are on the 1/scale grid, so the f32
    # adds equal the fixed-point adds the kernel would have made.  The
    # prior write is gated on pend.write: a rollouts == 0 search leaves the
    # root row of a pre-grown tree alone; on bf16 planes it rounds the row
    # once, as the flush's backup rounds each add.
    row = pend.newp
    if level == 2:
        tree.prior.copy_(K.unpack1_prior(plane, layout))
        tree.wsum.copy_(K.unpack1_wsum(plane, layout))
        tree.visits.copy_(K.unpack1_visits(plane, layout))
        row = K.quantize_prior(row)
    elif level == 1:
        tree.wsum.copy_(K.unpack_wsum(plane, scale))
        tree.visits.copy_(K.unpack_visits(plane))
    write_where(_node_rows(tree.prior), pend.leaf,
                pend.write & (pend.leaf < V), row.T)
    backup_flush(tree, pend)
    if final_root_policy:
        root_pi = node_policy(tree.prior[:, 0, :], tree.wsum[:, 0, :],
                              tree.visits[:, 0, :], cpuct)
    return tree, root_pi
