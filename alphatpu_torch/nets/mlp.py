"""AlphaZero residual MLP as a torch ``nn.Module``.

Counterpart of :mod:`alphatpu.nets.mlp`, with the same architecture and the
same parameter names and layouts:

* base: ``relu(x @ base)``, no bias,
* tower: ``depth`` residual blocks ``b = relu(b + relu(b @ res[i]))``,
* policy head ``b @ policy_w + policy_b`` (raw logits), value head
  ``sigmoid(b @ value_w + value_b)``, and the training-only feature head
  ``feature_w``/``feature_b``, kept so that the weight sets line up.

Weights are stored ``[in, out]`` as the reference stores them, so
:func:`params_from_jax` copies arrays without transposes and the forward is
``x @ W``.  The forward runs in float32; TF32 matmuls are switched off at
import (``torch.backends.cuda.matmul.allow_tf32 = False``) because the
reference it is held to computes full float32 products.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from torch import nn

# full float32 products on the card, like the reference (see module doc)
torch.backends.cuda.matmul.allow_tf32 = False


class NetConfig(NamedTuple):
    in_dim: int
    actions: int
    fsize: int
    width: int = 512
    depth: int = 4


def config_for_game(game, width: int = 512, depth: int | None = None) -> NetConfig:
    """The reference's per-game sizes: 512x4 Connect-4/Reversi6, 512x6
    Gobang, 512x8 Hex/Reversi8, 128x6 TicTacToe."""
    if depth is None:
        name = game.name
        if name == "tictactoe":
            width, depth = 128, 6
        elif name.startswith("gobang"):
            depth = 6
        elif name.startswith("hex") or name == "reversi8x8":
            depth = 8
        else:
            depth = 4
    return NetConfig(
        in_dim=2 * game.vectorized_state,
        actions=game.max_actions,
        fsize=game.feature_size,
        width=width,
        depth=depth,
    )


def _shapes(cfg: NetConfig) -> Dict[str, tuple]:
    return {
        "base": (cfg.in_dim, cfg.width),
        "res": (cfg.depth, cfg.width, cfg.width),
        "policy_w": (cfg.width, cfg.actions),
        "policy_b": (cfg.actions,),
        "value_w": (cfg.width, 1),
        "value_b": (1,),
        "feature_w": (cfg.width, cfg.fsize),
        "feature_b": (cfg.fsize,),
    }


def init_numpy(cfg: NetConfig, seed: int) -> Dict[str, np.ndarray]:
    """Glorot-uniform weights and zero biases from a numpy seed, as a flat
    ``{name: array}`` dict in the reference's layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in _shapes(cfg).items():
        if name.endswith("_b"):
            out[name] = np.zeros(shape, np.float32)
            continue
        fan_in, fan_out = shape[-2], shape[-1]
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        out[name] = rng.uniform(-limit, limit, size=shape).astype(np.float32)
    return out


class MLP(nn.Module):
    """Inference forward of the residual MLP: ``(logits [G, A], value [G])``."""

    def __init__(self, cfg: NetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name, shape in _shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=device),
                requires_grad=False))

    @classmethod
    def from_seed(cls, cfg: NetConfig, seed: int, device=None) -> "MLP":
        return params_from_jax(init_numpy(cfg, seed), cfg, device=device)

    def forward(self, x: torch.Tensor):
        b = torch.relu(x @ self.base)
        for w in self.res:
            b = torch.relu(b + torch.relu(b @ w))
        logits = b @ self.policy_w + self.policy_b
        value = torch.sigmoid(b @ self.value_w + self.value_b)
        return logits, value[..., 0]


def params_from_jax(flat: Dict[str, np.ndarray], cfg: NetConfig,
                    device=None) -> MLP:
    """An :class:`MLP` holding the reference's parameters.

    ``flat`` is the JAX param dict as numpy arrays (``base``, ``res``,
    ``policy_w``, ...), either bare or under the ``best/`` prefix that
    :func:`alphatpu.checkpoint.save_checkpoint` writes; other checkpoint
    keys (``train/``, ``opt/``, ``rng``) are ignored.  Shapes are checked
    against ``cfg``."""
    prefix = "best/" if any(k.startswith("best/") for k in flat) else ""
    net = MLP(cfg, device=device)
    with torch.no_grad():
        for name, shape in _shapes(cfg).items():
            arr = np.array(flat[prefix + name], dtype=np.float32)
            if arr.shape != shape:
                raise ValueError(
                    f"{prefix + name}: shape {arr.shape}, expected {shape}")
            getattr(net, name).copy_(torch.from_numpy(arr))
    return net
