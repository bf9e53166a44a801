"""AlphaZero residual MLP as a torch ``nn.Module``.

Counterpart of :mod:`alphatpu.nets.mlp`, with the same architecture and the
same parameter names and layouts:

* base: ``relu(x @ base)``, no bias,
* tower: ``depth`` residual blocks ``b = relu(b + relu(b @ res[i]))``,
* policy head ``b @ policy_w + policy_b`` (raw logits), value head
  ``sigmoid(b @ value_w + value_b)``, and the training-only feature head
  ``tanh(b @ feature_w + feature_b)``.

Weights are stored ``[in, out]`` as the reference stores them, so
:func:`params_from_jax` and :func:`params_to_numpy` copy arrays without
transposes and the forward is ``x @ W``.  The forward runs in float32 by
default; TF32 matmuls are switched off at import
(``torch.backends.cuda.matmul.allow_tf32 = False``) because the reference it
is held to computes full float32 products.  ``compute_dtype=bfloat16``
keeps the tower's activations in bfloat16, as the reference's
``apply_inference`` does.

An in-search net holds parameters that need no gradient; the learner's
net is built with ``trainable=True`` (:meth:`MLP.copy`), and the search
calls every net under ``torch.no_grad()``.
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


PARAM_NAMES = tuple(_shapes(NetConfig(1, 1, 1)))


class MLP(nn.Module):
    """The residual MLP.  ``forward`` is the inference forward
    ``(logits [G, A], value [G])``; :meth:`forward_training` adds the
    feature head."""

    def __init__(self, cfg: NetConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        for name, shape in _shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=device),
                requires_grad=trainable))

    @classmethod
    def from_seed(cls, cfg: NetConfig, seed: int, device=None,
                  trainable: bool = False) -> "MLP":
        return params_from_jax(init_numpy(cfg, seed), cfg, device=device,
                               trainable=trainable)

    def copy(self, trainable: bool | None = None) -> "MLP":
        """A new net holding a copy of these parameters, trainable as given
        (default: as this one)."""
        if trainable is None:
            trainable = self.base.requires_grad
        out = MLP(self.cfg, device=self.base.device, trainable=trainable)
        with torch.no_grad():
            for name in PARAM_NAMES:
                getattr(out, name).copy_(getattr(self, name))
        return out

    def _trunk(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The base layer and the tower, activations kept in ``dtype``."""
        b = torch.relu(x.to(dtype) @ self.base.to(dtype))
        for w in self.res.to(dtype):
            b = torch.relu(b + torch.relu(b @ w))
        return b

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32):
        b = self._trunk(x, compute_dtype)
        # the heads take the tower's output as it is and sum in float32 (the
        # products of two bfloat16 values are exact in float32), as the
        # reference's float32-accumulating dots do
        b = b.float()
        logits = b @ self.policy_w.to(compute_dtype).float() + self.policy_b
        value = torch.sigmoid(b @ self.value_w.to(compute_dtype).float()
                              + self.value_b)
        return logits, value[..., 0]

    def forward_training(self, x: torch.Tensor):
        """``(logits, value, feature)``, all float32: the SGD path."""
        b = self._trunk(x, torch.float32)
        logits = b @ self.policy_w + self.policy_b
        value = torch.sigmoid(b @ self.value_w + self.value_b)
        feature = torch.tanh(b @ self.feature_w + self.feature_b)
        return logits, value[..., 0], feature


def apply_inference(net: MLP, x: torch.Tensor, compute_dtype=torch.float32):
    """``(logits, value)`` of ``net`` with the tower in ``compute_dtype``:
    the in-search evaluation, as the reference's ``apply_inference``."""
    return net(x, compute_dtype)


def params_from_jax(flat: Dict[str, np.ndarray], cfg: NetConfig,
                    device=None, prefix: str | None = None,
                    trainable: bool = False) -> MLP:
    """An :class:`MLP` holding the reference's parameters.

    ``flat`` is the JAX param dict as numpy arrays (``base``, ``res``,
    ``policy_w``, ...), bare or under a checkpoint prefix (``best/``,
    ``train/``).  ``prefix=None`` takes ``best/`` where the dict has it,
    else the bare names; other keys are ignored.  Shapes are checked
    against ``cfg``."""
    if prefix is None:
        prefix = "best/" if any(k.startswith("best/") for k in flat) else ""
    net = MLP(cfg, device=device, trainable=trainable)
    with torch.no_grad():
        for name, shape in _shapes(cfg).items():
            arr = np.array(flat[prefix + name], dtype=np.float32)
            if arr.shape != shape:
                raise ValueError(
                    f"{prefix + name}: shape {arr.shape}, expected {shape}")
            getattr(net, name).copy_(torch.from_numpy(arr))
    return net


def params_to_numpy(net: MLP, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: ``{prefix + name: float32
    array}`` under the reference's names and layouts."""
    return {prefix + name: getattr(net, name).detach().cpu().numpy()
            for name in PARAM_NAMES}
