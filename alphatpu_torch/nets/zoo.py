"""Network zoo: other architectures behind the ``(logits, value)`` contract
of :class:`~alphatpu_torch.nets.mlp.MLP`.

Counterpart of :mod:`alphatpu.nets.zoo`: ``res2`` (two-layer residual
blocks), ``norm`` (the same with a layer norm), the conv tower of
:func:`make_conv_net`, ``value_only`` (a flat policy) and ``recurrent`` (a
GRU over three steps).  Each is an ``nn.Module`` whose ``forward(x)``
returns ``(logits f32[B, A], value f32[B])``, the callable ``run_mcts``,
selfplay and the duel take, so any of them can drive a search.  Like the
reference's, they are off the training path: the pipeline builds the MLP.

Parameters keep the reference's names and shapes, weights ``[in, out]``,
except the conv weights, kept OIHW (PyTorch's layout) and converted from
and to the reference's HWIO by :func:`params_from_jax` and
:func:`params_to_numpy`.  Inits come from a numpy seed: Glorot-uniform
weights (the fans of a 3x3 kernel count its 9 taps, as JAX's do), zero
biases, unit layer-norm scales.  Convolutions run in float32 without
TF32 (``torch.backends.cudnn.allow_tf32 = False``, set at import), as
the MLP's matmuls do.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .mlp import MLP, NetConfig
from .mlp import params_from_jax as mlp_from_jax
from .mlp import params_to_numpy as mlp_to_numpy

# full float32 convolutions on the card, like the reference
torch.backends.cudnn.allow_tf32 = False


class ConvConfig(NamedTuple):
    rows: int
    cols: int
    actions: int
    channels: int = 64
    depth: int = 4


def conv_config(game, channels: int = 64, depth: int = 4) -> ConvConfig:
    """The conv tower's shape on ``game``'s board."""
    spec = getattr(game, "spec", None)
    rows = getattr(spec, "rows", None) or game.n
    cols = getattr(spec, "cols", None) or game.n
    return ConvConfig(rows, cols, game.max_actions, channels, depth)


def _init(shapes: Dict[str, tuple], seed: int) -> Dict[str, np.ndarray]:
    """Glorot-uniform weights, zero biases, unit scales, in ``shapes``'
    order.  The fans of an ``[in, out]`` matrix (or a stack of them) are
    its last two dims; those of an OIHW kernel (or a stack) count its
    taps, ``I * kh * kw`` and ``O * kh * kw``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("_b") or name == "bias":
            out[name] = np.zeros(shape, np.float32)
        elif name == "scale":
            out[name] = np.ones(shape, np.float32)
        else:
            if len(shape) >= 4:
                o, i, kh, kw = shape[-4:]
                fan_in, fan_out = i * kh * kw, o * kh * kw
            else:
                fan_in, fan_out = shape[-2], shape[-1]
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            out[name] = rng.uniform(-limit, limit, size=shape).astype(
                np.float32)
    return out


class ZooNet(nn.Module):
    """Float32 parameters named and shaped as ``shapes(cfg)`` gives them;
    subclasses add the forward."""

    def __init__(self, cfg, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        for name, shape in self.shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=device),
                requires_grad=trainable))

    @staticmethod
    def shapes(cfg) -> Dict[str, tuple]:
        raise NotImplementedError

    @classmethod
    def from_seed(cls, cfg, seed: int, device=None, trainable: bool = False):
        net = cls(cfg, device=device, trainable=trainable)
        net.load_numpy(_init(cls.shapes(cfg), seed))
        return net

    def load_numpy(self, flat: Dict[str, np.ndarray]) -> None:
        """Copy ``flat`` (this net's names and shapes) into the parameters."""
        with torch.no_grad():
            for name, shape in self.shapes(self.cfg).items():
                arr = np.array(flat[name], dtype=np.float32)
                if arr.shape != shape:
                    raise ValueError(f"{name}: shape {arr.shape}, expected "
                                     f"{shape}")
                getattr(self, name).copy_(torch.from_numpy(arr))

    def heads(self, b: torch.Tensor):
        logits = b @ self.policy_w + self.policy_b
        value = torch.sigmoid(b @ self.value_w + self.value_b)
        return logits, value[..., 0]


class Res2(ZooNet):
    """Two-layer residual blocks (the reference's resnet/resnetb/resnetd):
    ``b = relu(b + relu(b @ res_a[i]) @ res_b[i])``."""

    @staticmethod
    def shapes(cfg: NetConfig):
        W, D = cfg.width, cfg.depth
        return {"base": (cfg.in_dim, W), "res_a": (D, W, W),
                "res_b": (D, W, W), "policy_w": (W, cfg.actions),
                "policy_b": (cfg.actions,), "value_w": (W, 1),
                "value_b": (1,)}

    def forward(self, x):
        b = torch.relu(x @ self.base)
        for wa, wb in zip(self.res_a, self.res_b):
            b = torch.relu(b + torch.relu(b @ wa) @ wb)
        return self.heads(b)


class Norm(ZooNet):
    """Res2 with a layer norm of each block's sum before its relu (the
    reference's resnetbatch, LayerNorm for BatchNorm).  ``jnp.var`` is the
    population variance and eps 1e-5 sits inside the rsqrt: that is
    ``F.layer_norm`` with ``scale`` and ``bias`` as its weight and bias."""

    @staticmethod
    def shapes(cfg: NetConfig):
        return {**Res2.shapes(cfg), "scale": (cfg.depth, cfg.width),
                "bias": (cfg.depth, cfg.width)}

    def forward(self, x):
        b = torch.relu(x @ self.base)
        for wa, wb, sc, bi in zip(self.res_a, self.res_b, self.scale,
                                  self.bias):
            h = b + torch.relu(b @ wa) @ wb
            b = torch.relu(F.layer_norm(h, h.shape[-1:], sc, bi, eps=1e-5))
        return self.heads(b)


class ValueOnly(ZooNet):
    """The reference's networkq: the MLP's tower and value head; the
    logits are ``policy_b`` broadcast to ``[B, A]`` (a flat prior at
    init), so the search is guided by the value alone."""

    @staticmethod
    def shapes(cfg: NetConfig):
        W = cfg.width
        return {"base": (cfg.in_dim, W), "res": (cfg.depth, W, W),
                "value_w": (W, 1), "value_b": (1,),
                "policy_b": (cfg.actions,)}

    def forward(self, x):
        b = torch.relu(x @ self.base)
        for w in self.res:
            b = torch.relu(b + torch.relu(b @ w))
        value = torch.sigmoid(b @ self.value_w + self.value_b)
        logits = self.policy_b.expand(x.shape[:-1] + self.policy_b.shape)
        return logits, value[..., 0]


class Recurrent(ZooNet):
    """A GRU over ``STEPS`` thought steps on the base layer's output (the
    reference's network_rec).  Not ``nn.GRUCell``: the reset gate scales
    ``h`` before the candidate's matmul, ``[r * h, inp] @ gru_h``, there
    are no biases, and the update is ``(1 - z) * h + z * hc``."""

    STEPS = 3

    @staticmethod
    def shapes(cfg: NetConfig):
        W = cfg.width
        return {"base": (cfg.in_dim, W), "gru_z": (2 * W, W),
                "gru_r": (2 * W, W), "gru_h": (2 * W, W),
                "policy_w": (W, cfg.actions), "policy_b": (cfg.actions,),
                "value_w": (W, 1), "value_b": (1,)}

    def forward(self, x):
        h = torch.relu(x @ self.base)
        inp = h
        for _ in range(self.STEPS):
            hx = torch.cat([h, inp], -1)
            z = torch.sigmoid(hx @ self.gru_z)
            r = torch.sigmoid(hx @ self.gru_r)
            hc = torch.tanh(torch.cat([r * h, inp], -1) @ self.gru_h)
            h = (1 - z) * h + z * hc
        return self.heads(h)


# the reference's HWIO kernels <-> OIHW: (H, W, I, O) -> (O, I, H, W)
_CONV_LAYOUT = {"stem": ((3, 2, 0, 1), (2, 3, 1, 0)),
                "convs": ((0, 4, 3, 1, 2), (0, 3, 4, 2, 1))}


class ConvNet(ZooNet):
    """The conv tower (the reference's ressimplec): the two input planes
    as an image, a 3x3 stem, ``depth`` residual 3x3 convolutions
    ``h = relu(h + conv(h))`` and both heads on the flattened image.

    The encoding stores cells column-major (cell ``r + rows * c``), so the
    input is ``x.reshape(B, 2, cols, rows)`` with rows and columns swapped;
    the heads read the image flattened in the reference's NHWC order
    (row, column, channel), so the image is permuted to NHWC before the
    flatten.  "SAME" for a 3x3 kernel is ``padding=1``."""

    @staticmethod
    def shapes(cfg: ConvConfig):
        C, flat = cfg.channels, cfg.rows * cfg.cols * cfg.channels
        return {"stem": (C, 2, 3, 3), "convs": (cfg.depth, C, C, 3, 3),
                "policy_w": (flat, cfg.actions), "policy_b": (cfg.actions,),
                "value_w": (flat, 1), "value_b": (1,)}

    def forward(self, x):
        B, c = x.shape[0], self.cfg
        img = x.reshape(B, 2, c.cols, c.rows).transpose(2, 3)  # NCHW
        h = torch.relu(F.conv2d(img, self.stem, padding=1))
        for w in self.convs:
            h = torch.relu(h + F.conv2d(h, w, padding=1))
        return self.heads(h.permute(0, 2, 3, 1).reshape(B, -1))


def conv_from_hwio(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The reference's conv parameters with the kernels made OIHW."""
    return {k: np.transpose(v, _CONV_LAYOUT[k][0]) if k in _CONV_LAYOUT
            else v for k, v in flat.items()}


ZOO = {
    "mlp": MLP,
    "res2": Res2,
    "norm": Norm,
    "value_only": ValueOnly,
    "recurrent": Recurrent,
}


def make_net(name: str, cfg: NetConfig, seed: int, device=None,
             trainable: bool = False) -> nn.Module:
    """The zoo architecture ``name`` with weights from numpy ``seed``."""
    return ZOO[name].from_seed(cfg, seed, device=device, trainable=trainable)


def make_conv_net(game, channels: int = 64, depth: int = 4, seed: int = 0,
                  device=None, trainable: bool = False) -> ConvNet:
    """The conv tower on ``game``'s board with weights from numpy
    ``seed``."""
    return ConvNet.from_seed(conv_config(game, channels, depth), seed,
                             device=device, trainable=trainable)


def params_from_jax(name: str, flat: Dict[str, np.ndarray], cfg,
                    device=None, trainable: bool = False) -> nn.Module:
    """The net ``name`` (a ``ZOO`` key, or ``"conv"`` with a
    :class:`ConvConfig`) holding the reference's parameters ``flat``
    (``{name: array}``, its layouts)."""
    if name == "mlp":
        return mlp_from_jax(flat, cfg, device, "", trainable)
    if name == "conv":
        net = ConvNet(cfg, device=device, trainable=trainable)
        net.load_numpy(conv_from_hwio(flat))
        return net
    net = ZOO[name](cfg, device=device, trainable=trainable)
    net.load_numpy(flat)
    return net


def params_to_numpy(net: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: ``{name: float32 array}``
    in the reference's names and layouts."""
    if isinstance(net, MLP):
        return mlp_to_numpy(net)
    flat = {name: p.detach().cpu().numpy()
            for name, p in net.named_parameters()}
    if isinstance(net, ConvNet):
        flat = {k: np.ascontiguousarray(np.transpose(v, _CONV_LAYOUT[k][1]))
                if k in _CONV_LAYOUT else v for k, v in flat.items()}
    return flat
