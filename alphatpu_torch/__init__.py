"""alphatpu_torch - the PyTorch / CUDA port of :mod:`alphatpu`.

The JAX package beside this one is the reference: every module here is
named after its counterpart there and is held to it by the tests under
``tests/test_torch_*.py``.  This package imports ``torch`` and never
``jax``; importing it builds nothing (the CUDA kernels under ``csrc/`` are
compiled on first use, see :mod:`alphatpu_torch._build`).

Ported so far: the training loop for all five game families - bitboards
and the rules, the residual MLP, the MCTS with its five hand-written Hopper
kernels, the replay buffer, selfplay in both modes, the learner, the
gating duel, checkpoints, the pipeline and the CLI (``python -m
alphatpu_torch.cli``).
"""

__version__ = "0.1.0"
