"""The residual MLP's inference forward, plain NumPy in float32.

``relu(x @ base)``, then ``depth`` blocks ``b = relu(b + relu(b @ w))``;
the policy logits ``b @ policy_w + policy_b`` and the value
``sigmoid(b @ value_w + value_b)``.  Weights are ``[in, out]``.
"""
from __future__ import annotations

import numpy as np


def forward(weights: dict, x: np.ndarray) -> tuple:
    """``(logits float32[N, A], value float32[N])`` of inputs [N, in]."""
    b = np.maximum(x.astype(np.float32) @ weights["base"], 0)
    for w in weights["res"]:
        b = np.maximum(b + np.maximum(b @ w, 0), 0)
    logits = b @ weights["policy_w"] + weights["policy_b"]
    z = (b @ weights["value_w"] + weights["value_b"])[:, 0]
    return logits, np.float32(1) / (np.float32(1) + np.exp(-z))


def softmax(logits: np.ndarray) -> np.ndarray:
    """Along the last axis, float32."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)

