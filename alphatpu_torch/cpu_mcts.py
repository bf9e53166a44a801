"""Production single-game CPU MCTS - the reference's `fast_mcts.jl` twin.

Counterpart of :mod:`alphatpu.cpu_mcts`, copied unchanged below this
docstring: a pure Python/numpy engine over the host-side rule oracles
(:mod:`alphatpu_torch.oracles`), with a numpy forward of the net's
parameters as :func:`alphatpu_torch.nets.params_to_numpy` gives them
(``base``, ``res`` stacked ``[depth, width, width]``, ``policy_w/b``,
``value_w/b``; weights ``[in, out]``).

:class:`ScalarMCTS` implements the reference GPU algorithm's semantics
node by node (mcts_gpu.jl:100-339), including the quirks the batched
engine must reproduce:

* the regularized-policy Newton solve with the 1e-4 gap floor, 1e-3
  tolerance, and repeat-error early exit,
* the `uptodate` protocol exactly as in the reference: a node's policy is
  recomputed on every traversal once it has been backed-up through
  (uptodate is never reset to 1),
* CDF sampling with last-positive fallback,
* lazy child allocation (one new node per rollout max),
* root-only 0.75/0.25 uniform prior mixing during training,
* backup with value flip and incremental-mean q of (1 - value).

It consumes injected uniforms, which doubles as the test hook.
:class:`MctsContext` wraps it with a real RNG and a net for production use
(interactive play without a card, ``python -m alphatpu_torch.interactive
--cpu``).
"""
from __future__ import annotations

import numpy as np

F = np.float32


class Node:
    __slots__ = (
        "parent", "action_from", "state", "expanded", "uptodate",
        "prior", "policy", "q", "visits", "child",
    )

    def __init__(self, num_actions, parent=-1, action_from=0, state=None):
        self.parent = parent
        self.action_from = action_from
        self.state = state
        self.expanded = False
        self.uptodate = True
        self.prior = np.zeros(num_actions, F)
        self.policy = np.zeros(num_actions, F)
        self.q = np.zeros(num_actions, F)
        self.visits = np.zeros(num_actions, F)
        self.child = {}


def newton_alpha(prior, q, lam):
    """Scalar Newton solve over all actions (mcts_gpu.jl:133-162)."""
    alpha = F(0.0)
    for k in range(len(prior)):
        gap = max(lam * prior[k], F(1e-4))
        alpha = max(alpha, F(q[k] + gap))
    err = np.inf
    for _ in range(100):
        s = F(0.0)
        g = F(0.0)
        for k in range(len(prior)):
            top = F(lam * prior[k])
            bot = F(alpha - q[k])
            s = F(s + top / bot)
            g = F(g - top / (bot * bot))
        newerr = F(s - 1.0)
        if newerr < F(1e-3) or newerr == err:
            break
        alpha = F(alpha - newerr / g)
        err = newerr
    return alpha


def regularized_pi(node, cpuct):
    n = F(1.0 + node.visits.sum())
    a_cnt = F((node.prior > 0).sum())
    lam = F(cpuct * np.sqrt(n) / (a_cnt + n))
    alpha = newton_alpha(node.prior, node.q, lam)
    return (lam * node.prior / (alpha - node.q)).astype(F)


def cdf_pick(pi, prob):
    """First positive-prob action whose inclusive prefix sum reaches prob;
    last positive action as fallback (mcts_gpu.jl:172-182)."""
    pr = F(0.0)
    best = -1
    for k, d in enumerate(pi):
        pr = F(pr + d)
        if d > 0:
            best = k
            if pr >= prob:
                return k
    return best if best >= 0 else 0


class ScalarMCTS:
    def __init__(self, game_oracle, num_actions, cpuct, training,
                 prior_fn, value_fn):
        self.g = game_oracle
        self.A = num_actions
        self.cpuct = F(cpuct)
        self.training = training
        self.prior_fn = prior_fn
        self.value_fn = value_fn

    def search(self, root_state, probs):
        """probs: [rollouts, depth] uniforms for this game.
        Returns (nodes, root_policy)."""
        nodes = [Node(self.A, state=root_state)]
        for r in range(probs.shape[0]):
            leaf = self._descend(nodes, probs[r])
            self._expand(nodes, leaf)
            self._backup(nodes, leaf)
        return nodes, nodes[0].policy.copy()

    def _descend(self, nodes, prob_row):
        idx = 0
        depth = 0
        while nodes[idx].expanded:
            node = nodes[idx]
            if not node.uptodate:
                node.policy = regularized_pi(node, self.cpuct)
                # reference never resets uptodate (mcts_gpu.jl:114-169)
            a = cdf_pick(node.policy, prob_row[depth])
            if a not in node.child:
                new = len(nodes)
                child = Node(
                    self.A, parent=idx, action_from=a,
                    state=self.g.play(node.state, a),
                )
                nodes.append(child)
                node.child[a] = new
            idx = node.child[a]
            depth += 1
        return idx

    def _expand(self, nodes, leaf):
        node = nodes[leaf]
        done, _ = self.g.is_over(node.state)
        node.expanded = not done
        if not done:
            legal = set(self.g.legal_actions(node.state))
            raw = self.prior_fn(node.state)
            p = np.zeros(self.A, F)
            for a in legal:
                p[a] = raw[a]
            norm = F(p.sum())
            if leaf == 0 and self.training:
                a_cnt = F(len(legal))
                for a in legal:
                    p[a] = F(0.75 * p[a] / norm + 0.25 / a_cnt)
            else:
                p = (p / norm).astype(F)
            node.prior = p
        node.policy = node.prior.copy()

    def _backup(self, nodes, leaf):
        node = nodes[leaf]
        done, res = self.g.is_over(node.state)
        if done:
            value = F((1.0 + node.state["player"] * res) / 2.0)
        else:
            value = F(self.value_fn(node.state))
        idx = node.parent
        move = node.action_from
        while idx >= 0:
            cur = nodes[idx]
            cur.q[move] = F(
                (cur.visits[move] * cur.q[move] + (1.0 - value))
                / (cur.visits[move] + 1.0)
            )
            cur.visits[move] = F(cur.visits[move] + 1.0)
            cur.uptodate = False
            move = cur.action_from
            idx = cur.parent
            value = F(1.0 - value)


# ---------------------------------------------------------------------------
# production wrapper: numpy net forward + oracle mapping + MctsContext
# ---------------------------------------------------------------------------


def numpy_net(params):
    """(prior_fn, value_fn) evaluating the checkpoint pytree with numpy -
    the CPU twin of nets.apply_inference (reference snetwork2 CPU method,
    DenseNet.jl:306-316).  Input: an oracle state dict; encoding matches
    game.encode (mover planes then opponent planes, cell = r + rows * c)."""
    P = {k: np.asarray(v, np.float32) for k, v in params.items()}

    def relu(x):
        return np.maximum(x, 0.0)

    def forward(st):
        mover = st["mover"].T.reshape(-1).astype(np.float32)
        other = st["other"].T.reshape(-1).astype(np.float32)
        x = np.concatenate([mover, other])
        b = relu(x @ P["base"])
        for w in P["res"]:
            b = relu(b + relu(b @ w))
        logits = b @ P["policy_w"] + P["policy_b"]
        logits -= logits.max()
        e = np.exp(logits)
        prior = (e / e.sum()).astype(F)
        value = 1.0 / (1.0 + np.exp(-(b @ P["value_w"] + P["value_b"])))
        return prior, F(value[0])

    return (lambda st: forward(st)[0]), (lambda st: forward(st)[1])


def oracle_for_game(game):
    """The numpy rule oracle matching a framework game object."""
    from .oracles import (
        OracleConnect4,
        OracleGobang,
        OracleHex,
        OracleReversi,
    )

    name = game.name
    if name == "connect4":
        return OracleConnect4()
    if name == "tictactoe" or name.startswith("gobang"):
        return OracleGobang(game.n, game.nvict)
    if name.startswith("hex"):
        return OracleHex(game.n)
    if name.startswith("reversi"):
        return OracleReversi(game.size)
    raise ValueError(f"no oracle for {name}")


class MctsContext:
    """Callable single-game searcher, the reference `MctsContext`
    (fast_mcts.jl:267-308): ``ctx(state, readout)`` runs ``readout``
    rollouts from ``state`` and returns ``(pi_root, v_root)`` where
    ``v_root`` is the visit-weighted root value (the reference's
    `extractRoot`)."""

    def __init__(self, cpuct, game, params, *, training=False, seed=0):
        self.oracle = oracle_for_game(game)
        prior_fn, value_fn = numpy_net(params)
        self.engine = ScalarMCTS(
            self.oracle, game.max_actions, cpuct, training,
            prior_fn, value_fn,
        )
        self.max_depth = game.max_game_length
        self.rng = np.random.default_rng(seed)

    def __call__(self, state, readout):
        probs = self.rng.random((readout, self.max_depth), dtype=np.float32)
        nodes, _ = self.engine.search(state, probs)
        root = nodes[0]
        total = root.visits.sum()
        pi = (root.visits / total).astype(F) if total > 0 else root.policy
        v = F((root.q * root.visits).sum() / total) if total > 0 else F(0.5)
        return pi, v
