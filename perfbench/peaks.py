"""The yardstick's arithmetic: the card's peaks and the net's operations.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit), by the type a matrix product runs in.  A float32 product runs
outside the tensor cores unless TF32 is allowed, which is read at run
time, after the program has been imported and has set it.
"""
from __future__ import annotations

import torch

PEAK_FLOPS = {
    "float32": 67e12,
    "tf32": 495e12,
    "bfloat16": 989e12,
}


def matmul_type(tower_dtype: str) -> str:
    """The type the tower's products run in: the configuration's, where
    it is float32 as TF32 is allowed or not at this moment."""
    if tower_dtype != "float32":
        return tower_dtype
    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest")
    return "tf32" if tf32 else "float32"


def net_flops_per_eval(in_dim: int, width: int, depth: int,
                       actions: int) -> int:
    """Operations of one inference forward of the residual MLP, two a
    multiply-add of its products: the base layer, the ``depth`` blocks of
    the tower, the policy head and the value head (the training-only
    feature head is not run; biases and activations are not counted)."""
    return 2 * (in_dim * width + depth * width * width + width * actions
                + width)
