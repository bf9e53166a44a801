"""Batched regularized-policy MCTS (counterpart of :mod:`alphatpu.mcts`)."""
