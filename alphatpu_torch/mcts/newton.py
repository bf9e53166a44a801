"""Batched regularized-policy solve (Grill et al. 2020) and the CDF sample.

Counterpart of :mod:`alphatpu.mcts.newton`, over ``[A, G]`` tensors
(games minor):

    lambda = cpuct * sqrt(n) / (acts + n),   n = 1 + sum_a visits[a]
    solve  sum_a lambda * p[a] / (alpha - q[a]) = 1  for alpha
    pi[a]  = lambda * p[a] / (alpha - q[a])

with the reference's constants (at most 96 Newton steps, tolerance 1e-3,
gap floor 1e-4) and its latched rule: a lane stops for good once
``err < tol or err == prev_err``.  Sums over the action axis run in
action order, one row at a time, which is the order the CUDA kernel of
:mod:`alphatpu_torch.mcts.kernels` uses - so the two agree bit for bit.
"""
from __future__ import annotations

import torch

NEWTON_CHUNK = 8
NEWTON_MAX_CHUNKS = 12  # 96 steps at most
NEWTON_TOL = 1e-3
ALPHA_FLOOR = 1e-4


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (action) axis in action order."""
    acc = x[0]
    for a in range(1, x.shape[0]):
        acc = acc + x[a]
    return acc


def solve_alpha(top, q, alpha, conv, early_exit: bool = True):
    """Latched Newton iterations from ``alpha`` ([G]); lanes with ``conv``
    set never move.  Returns the final alpha.  ``early_exit`` stops
    between chunks once every lane has converged, which asks the device;
    without it all chunks run (the same alpha: a converged lane never
    moves), so nothing waits for the device."""
    prev_err = torch.full_like(alpha, float("inf"))
    conv = conv.clone()
    for _ in range(NEWTON_MAX_CHUNKS):
        if early_exit and bool(conv.all()):
            break
        for _ in range(NEWTON_CHUNK):
            r = 1.0 / (alpha[None, :] - q)
            frac = top * r
            s = row_sum(frac)
            grad = -row_sum(frac * r)
            err = s - 1.0
            conv = conv | (err < NEWTON_TOL) | (err == prev_err)
            delta = err / torch.where(grad == 0, 1.0, grad)
            alpha = torch.where(conv, alpha, alpha - delta)
            prev_err = torch.where(conv, prev_err, err)
    return alpha


def regularized_policy(prior, q, visits, cpuct):
    """prior/q/visits: f32[A, G] -> pi: f32[A, G] (not normalized exactly:
    the solve stops at tolerance).  Nothing here waits for the device: the
    solve runs all its chunks."""
    n = 1.0 + row_sum(visits)
    num_actions = (prior > 0).sum(0).to(torch.float32)
    lam = cpuct * torch.sqrt(n) / (num_actions + n)
    top = lam[None, :] * prior
    alpha0 = torch.amax(q + torch.clamp_min(top, ALPHA_FLOOR), dim=0)
    alpha = solve_alpha(top, q, alpha0,
                        torch.zeros_like(alpha0, dtype=torch.bool),
                        early_exit=False)
    return top / (alpha[None, :] - q)


def cdf_sample(pi, prob):
    """The first action whose inclusive prefix sum (in action order)
    reaches ``prob`` and has positive mass; else the last action with
    positive mass; else 0.  pi: [A, G], prob: [G] -> i32[G]."""
    A = pi.shape[0]
    first = torch.full(prob.shape, A, dtype=torch.int32, device=pi.device)
    last = torch.full(prob.shape, -1, dtype=torch.int32, device=pi.device)
    c = torch.zeros_like(prob)
    for a in range(A):
        c = c + pi[a]
        pos = pi[a] > 0
        first = torch.where((first == A) & (c >= prob) & pos, a, first)
        last = torch.where(pos, a, last)
    return torch.where(first < A, first, torch.clamp_min(last, 0))
