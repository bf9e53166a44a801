"""One batched MCTS search per position, plain NumPy in float32.

The search the configurations state: ``R`` rollouts into a pool of ``R``
nodes a game.  Each rollout

1. applies the previous rollout's writes: the prior row of its leaf, and
   its value backed up along its path (``wsum`` += the value seen from
   the edge's mover, ``visits`` += 1),
2. walks from the root: at each expanded node the regularized policy
   (Grill et al. 2020) of its prior, mean values and visits, solved by
   the latched Newton iteration (at most 96 steps, tolerance 1e-3), and
   the first action whose running sum of that policy reaches the
   depth's uniform; the walk stops at an unexpanded node or at an edge
   with no child yet,
3. evaluates the net at the leaf (the child's position is played), and
   expands the leaf: its prior row is the net's prior over the legal
   moves, normalized, at the root mixed ``0.75 p + 0.25 / legal`` when
   training, zero at a finished game; the value backed up is the game's
   result at a finished game, else the net's, rounded to the 1/S grid of
   the packed stats (S the largest power of two with ``2 R S <= 2**16``).

The root policy returned is the one the last rollout's walk computed.  Sums
over actions run in action order, in float32, as the search kernels sum.
"""
from __future__ import annotations

import numpy as np

from . import net

F32 = np.float32
NEWTON_CHUNK = 8
NEWTON_MAX_CHUNKS = 12
NEWTON_TOL = F32(1e-3)
ALPHA_FLOOR = F32(1e-4)


def value_scale(rollouts: int) -> int:
    s = 1
    while rollouts * s * 2 < 1 << 16:
        s *= 2
    return s


def sum0(x: np.ndarray) -> np.ndarray:
    """Sum over the action axis (0), one row after another, in float32."""
    return np.add.reduce(x, axis=0, dtype=x.dtype)


def regularized_policy(P, Q, N, cpuct: float) -> np.ndarray:
    """The policy of gathered node rows [A, n]; a node with no visits
    gives its prior."""
    nvis = sum0(N)
    n = F32(1) + nvis
    acts = sum0((P > 0).astype(F32))
    lam = F32(cpuct) * np.sqrt(n) / (acts + n)
    top = lam[None, :] * P
    alpha = np.max(Q + np.maximum(top, ALPHA_FLOOR), axis=0)
    fresh = nvis == 0
    conv = fresh.copy()
    prev_err = np.full_like(alpha, np.inf)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for _ in range(NEWTON_MAX_CHUNKS):
            if conv.all():
                break
            for _ in range(NEWTON_CHUNK):
                r = F32(1) / (alpha[None, :] - Q)
                frac = top * r
                err = sum0(frac) - F32(1)
                grad = -sum0(frac * r)
                conv = conv | (err < NEWTON_TOL) | (err == prev_err)
                delta = err / np.where(grad == 0, F32(1), grad)
                alpha = np.where(conv, alpha, alpha - delta)
                prev_err = np.where(conv, prev_err, err)
        pi = top / (alpha[None, :] - Q)
    return np.where(fresh[None, :], P, pi)


def cdf_sample(pi: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The first action whose running sum reaches ``u`` among those with
    mass; else the last action with mass; else 0.  pi [A, n]."""
    A = pi.shape[0]
    pos = pi > 0
    hit = (np.cumsum(pi, axis=0, dtype=pi.dtype) >= u[None, :]) & pos
    first = np.where(hit.any(0), hit.argmax(0), -1)
    last = np.where(pos.any(0), A - 1 - pos[::-1].argmax(0), 0)
    return np.where(first >= 0, first, last).astype(np.int64)


def search(game, weights: dict, me, opp, player, probs, cpuct: float,
           training: bool = True) -> np.ndarray:
    """Search every position ``(me[i], opp[i], player[i])`` with the
    uniforms ``probs`` float32[R, D, N] (one per rollout and depth).
    Returns the root policies, float32[A, N]."""
    R, D, N = probs.shape
    V, A = R, game.actions
    scale = F32(value_scale(R))
    lanes = np.arange(N)
    child = np.zeros((V, A, N), np.int64)
    expanded = np.zeros((V, N), bool)
    s_me = np.zeros((V,) + me.shape, bool)
    s_opp = np.zeros((V,) + opp.shape, bool)
    s_player = np.zeros((V, N), np.int8)
    s_me[0], s_opp[0], s_player[0] = me, opp, player
    prior = np.zeros((A, V, N), F32)
    wsum = np.zeros((A, V, N), F32)
    visits = np.zeros((A, V, N), F32)
    next_idx = np.ones(N, np.int64)
    pend = None
    root_pi = None
    for r in range(R):
        if pend is not None:
            nodes, actions, value, leaf, newp = pend
            w = np.nonzero(leaf < V)[0]
            prior[:, leaf[w], w] = newp[:, w]
            length = (nodes >= 0).sum(0)
            for d in range(D):
                on = np.nonzero(nodes[d] >= 0)[0]
                if not on.size:
                    break
                k = length[on] - 1 - d
                v = value[on]
                idx = (actions[d, on], nodes[d, on], on)
                wsum[idx] += np.where(k % 2 == 0, F32(1) - v, v)
                visits[idx] += F32(1)
        root_was_expanded = expanded[0].copy()

        # the walk
        node = np.zeros(N, np.int64)
        found = np.zeros(N, bool)
        needs_alloc = np.zeros(N, bool)
        leaf_action = np.zeros(N, np.int64)
        nodes = np.full((D, N), -1, np.int64)
        actions = np.zeros((D, N), np.int64)
        walk_pi = None
        for d in range(D):
            act = np.nonzero(~found)[0]
            if not act.size:
                break
            n_ = node[act]
            P = prior[:, n_, act]
            W = wsum[:, n_, act]
            Nv = visits[:, n_, act]
            with np.errstate(divide="ignore", invalid="ignore"):
                Q = np.where(Nv > 0, W / np.maximum(Nv, F32(1)), F32(0))
            pi = regularized_policy(P, Q, Nv, cpuct)
            if d == 0:
                walk_pi = pi
            a = cdf_sample(pi, probs[r, d, act])
            exp = expanded[n_, act]
            live = act[exp]
            nodes[d, live] = node[live]
            actions[d, live] = a[exp]
            cid = child[n_, a, act]
            missing = exp & (cid == 0)
            leaf_action[act[missing]] = a[missing]
            needs_alloc[act[missing]] = True
            found[act[~exp | missing]] = True
            moved = exp & (cid > 0)
            node[act[moved]] = cid[moved]

        # the leaf's position: the stored one, or the child's played
        l_me, l_opp = s_me[node, lanes], s_opp[node, lanes]
        l_player = s_player[node, lanes]
        al = np.nonzero(needs_alloc)[0]
        if al.size:
            p_me, p_opp, p_pl = game.play(l_me[al], l_opp[al], l_player[al],
                                          leaf_action[al])
            l_me[al], l_opp[al], l_player[al] = p_me, p_opp, p_pl
        logits, v = net.forward(weights, game.encode(l_me, l_opp))
        p_nn = net.softmax(logits).T

        # expand
        new = next_idx.copy()
        alloc = needs_alloc & (new < V)
        ia = np.nonzero(alloc)[0]
        child[node[ia], leaf_action[ia], ia] = new[ia]
        s_me[new[ia], ia], s_opp[new[ia], ia] = l_me[ia], l_opp[ia]
        s_player[new[ia], ia] = l_player[ia]
        next_idx += needs_alloc
        leaf = np.where(needs_alloc, new, node)
        done, result = game.is_over(l_me, l_opp, l_player)
        legal = game.legal(l_me, l_opp).T
        p = np.where(legal, p_nn, F32(0))
        p_norm = p / np.maximum(sum0(p), F32(1e-30))
        if training:
            a_cnt = np.maximum(sum0(legal.astype(F32)), F32(1))
            mixed = F32(0.75) * p_norm + F32(0.25) / a_cnt * legal.astype(F32)
            newp = np.where((leaf == 0)[None, :], mixed, p_norm)
        else:
            newp = p_norm
        newp = np.where(done[None, :], F32(0), newp).astype(F32)
        inside = np.nonzero(leaf < V)[0]
        expanded[leaf[inside], inside] = ~done[inside]

        root_pi = np.where(root_was_expanded[None, :], walk_pi, newp)
        terminal = (F32(1) + l_player.astype(F32) * result.astype(F32)) / F32(2)
        value = np.where(done, terminal, v.astype(F32))
        value = (np.round(value * scale) * (F32(1) / scale)).astype(F32)
        pend = (nodes, actions, value, leaf, newp)
    return root_pi


def choose(pi: np.ndarray, u: np.ndarray, sample: np.ndarray) -> np.ndarray:
    """The move from each root policy [A, n]: sampled at ``u`` times the
    policy's mass where ``sample``, else the first of the largest."""
    drawn = cdf_sample(pi, u.astype(F32) * sum0(pi))
    return np.where(sample, drawn, pi.argmax(0))
