"""The one traffic generator: it reads a mix (``traffic/<name>.json``)
and drives the system under test, ``alphatpu_torch``, with it.

A mix names its ``kind``; each kind is a class here that takes the cell's
configuration, the mix and the seed, makes the inputs (the net's weights
and the random streams, from the seed, on the device) and offers

* ``call()`` - one unit of the program's work, as its users call it,
* ``window(seconds)`` - whole units until ``seconds`` have passed,
* ``end_to_end(units, seconds)`` - the end-to-end metrics of a window,
* ``counts()`` - what the traced reduction needs to know of one unit.

``selfplay_continuous``: ``selfplay_continuous`` chained through one
episode carry into one replay buffer, ``rounds_per_call`` rounds a call,
every round a ``rollouts``-rollout search of every lane, replayed from the
CUDA graphs the program captures in the first (warm-up) call.
"""
from __future__ import annotations

import math
import zlib
from functools import partial
from time import perf_counter
from typing import NamedTuple

import numpy as np
import torch

from alphatpu_torch.buffer import create_buffer
from alphatpu_torch.games import make_game
from alphatpu_torch.nets import MLP, NetConfig, apply_inference
from alphatpu_torch.selfplay import (SelfplayConfig, make_carry,
                                     selfplay_continuous)

from .reference import games as ref_games

TOWER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BIAS_LIMIT = 0.1


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run ``seed`` (any whole
    number)."""
    seq = np.random.SeedSequence([seed % (1 << 64), zlib.crc32(tag.encode())])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def net_shapes(game: ref_games.Game, width: int, depth: int) -> dict:
    """The residual MLP's parameters, ``[in, out]``: the inputs are the two
    sides' cells, the policy one logit an action, the training-only
    feature head one output a cell."""
    c = game.cells
    return {"base": (2 * c, width), "res": (depth, width, width),
            "policy_w": (width, game.actions), "policy_b": (game.actions,),
            "value_w": (width, 1), "value_b": (1,),
            "feature_w": (width, c), "feature_b": (c,)}


# the axes of each parameter that run over the tower's hidden units
UNIT_AXES = {"base": (1,), "res": (1, 2), "policy_w": (0,), "value_w": (0,),
             "feature_w": (0,)}


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Glorot-uniform weights and uniform biases in +-0.1, float32, drawn
    on ``device`` in one call from a fixed stream, with the tower's hidden
    units then put in an order drawn from ``seed``.  Every seed's net
    computes one function, so every seed's games ask the same work of the
    search; the order changes the rounding of every product."""
    gen = torch.Generator(device=device).manual_seed(derive(0, "weights"))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    order = torch.randperm(
        shapes["base"][1], device=device,
        generator=torch.Generator(device=device).manual_seed(
            derive(seed, "units")))
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        limit = (BIAS_LIMIT if name.endswith("_b")
                 else math.sqrt(6.0 / (shape[-2] + shape[-1])))
        w = (part * limit).view(shape)
        for axis in UNIT_AXES.get(name, ()):
            w = w.index_select(axis, order)
        out[name] = w.contiguous()
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Call(NamedTuple):
    """One call of the program and what its check reads."""

    carry_in: object  # the EpisodeCarry the call continued
    carry_out: object  # the EpisodeCarry it returned
    cursor: torch.Tensor  # the buffer's cursor before the call
    rng_state: torch.Tensor  # the stream's state before the call
    stats: dict  # the call's stats (0-d tensors)


class Selfplay:
    """Continuous selfplay of ``num_games`` lanes (module doc)."""

    kind = "selfplay_continuous"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 tower_dtype: str | None = None):
        self.device = dev = torch.device(device)
        self.config, self.traffic = config, traffic
        self.ref_game = ref_games.make(config["game"])
        self.game = make_game(config["game"])
        self.shapes = net_shapes(self.ref_game, config["width"],
                                 config["depth"])
        self.weights = make_weights(self.shapes, seed, dev)
        self.net = MLP(NetConfig(in_dim=self.shapes["base"][0],
                                 actions=self.ref_game.actions,
                                 fsize=self.ref_game.cells,
                                 width=config["width"],
                                 depth=config["depth"]), device=dev)
        with torch.no_grad():
            for name, w in self.weights.items():
                getattr(self.net, name).copy_(w)
        self.tower_dtype = tower_dtype or config["tower_dtype"]
        self.net_apply = partial(apply_inference, self.net,
                                 compute_dtype=TOWER_DTYPES[self.tower_dtype])
        self.G, self.T = config["num_games"], config["rounds_per_call"]
        self.R = config["rollouts"]
        self.cfg = SelfplayConfig(
            num_games=self.G, rollouts=self.R, cpuct=config["cpuct"],
            temp_moves=config["temp_moves"], continuous=True, rounds=self.T)
        self.buffer = create_buffer(self.game, config["buffer_rows"],
                                    device=dev)
        self.rng = torch.Generator(device=dev).manual_seed(
            derive(seed, "selfplay"))
        self.carry = make_carry(self.game, self.G, self.rng, dev)
        self.last: Call | None = None
        self.failures: list = []  # illegal moves + rows dropped, a call

    def call(self) -> None:
        state, cursor, carry_in = (self.rng.get_state(),
                                   self.buffer.cursor.clone(), self.carry)
        _, stats, carry = selfplay_continuous(
            self.game, self.net_apply, self.buffer, None, self.cfg, carry_in)
        self.last = Call(carry_in, carry, cursor, state, stats)
        self.carry = carry
        self.failures.append(stats["illegal_moves"] + stats["unfinished"])

    def window(self, seconds: float) -> tuple:
        """Whole calls until ``seconds`` have passed; the host runs at most
        one call ahead of the device.  Returns ``(calls, seconds)``;
        ``call_ends`` keeps the host clock as each call was seen done."""
        dev, cuda = self.device, self.device.type == "cuda"
        sync(dev)
        self.failures = []
        t0, calls, ahead = perf_counter(), 0, None
        self.call_ends = []
        while True:
            self.call()
            calls += 1
            if cuda:
                done = torch.cuda.Event()
                done.record()
                if ahead is not None:
                    ahead.synchronize()
                    self.call_ends.append(perf_counter() - t0)
                ahead = done
            if perf_counter() - t0 >= seconds:
                break
        sync(dev)
        t = perf_counter() - t0
        self.call_ends.append(t)
        return calls, t

    def moves(self, calls: int) -> int:
        """Moves decided: every lane moves every round."""
        return calls * self.G * self.T

    def end_to_end(self, calls: int, seconds: float) -> dict:
        return {"selfplay_steps_per_s": self.moves(calls) / seconds}

    def evaluations(self, calls: int) -> int:
        """Net evaluations: one a rollout of every lane."""
        return self.moves(calls) * self.R

    def counts(self) -> dict:
        """Of one call: its rollouts (rounds x rollouts a search)."""
        return {"kind": "selfplay", "rollouts": self.T * self.R}

    def failed(self) -> int:
        return int(torch.stack(self.failures).sum()) if self.failures else 0


KINDS = {Selfplay.kind: Selfplay}
