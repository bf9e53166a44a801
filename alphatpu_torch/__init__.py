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
alphatpu_torch.cli``); and evaluation and play - the probe engines and
``eval_vs_probe`` (``python -m alphatpu_torch.probe``), ``eval_vs_random``
and ``ladder``, the numpy CPU engine, text and SVG boards, and interactive
play (``python -m alphatpu_torch.interactive``); data-parallel training
over ``torch.distributed`` (:mod:`alphatpu_torch.parallel`, the CLI's
``--devices`` and ``--multihost``); and the net zoo
(:mod:`alphatpu_torch.nets.zoo`).
"""

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` as a torch device.  A CUDA device raises where torch finds
    none: an entry point runs on the CPU only when asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: torch finds no CUDA "
                           "device; pass device='cpu' (--device cpu) to run "
                           "on the CPU")
    return dev
