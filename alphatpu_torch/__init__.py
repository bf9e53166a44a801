"""alphatpu_torch - the PyTorch / CUDA port of :mod:`alphatpu`.

The JAX package beside this one is the reference: every module here is
named after its counterpart there and is held to it by the tests under
``tests/test_torch_*.py``.  This package imports ``torch`` and never
``jax``; importing it builds nothing (the CUDA kernels under ``csrc/`` are
compiled on first use, see :mod:`alphatpu_torch._build`).

Ported so far: the connect4 continuous-selfplay slice - bitboards, the
connect4 rules, the residual MLP, the packed-stat MCTS with its two
hand-written Hopper kernels, the replay buffer and continuous selfplay.
"""

__version__ = "0.1.0"
