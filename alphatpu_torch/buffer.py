"""Device-resident replay ring buffer.

Counterpart of :mod:`alphatpu.buffer`: one dense tensor per field,
written in place by fixed-shape scatters in round-major, then game order.
Encoded states and final-state features are 0/1 and {-1, +1}, stored as
int8.  In a world of D ranks (:mod:`alphatpu_torch.parallel`) each rank
holds its own shard, ``create_buffer(game, capacity // D)``, and samples
it; the reference's one buffer of D shards, with a ``(D,)`` cursor and
total, appears only in a checkpoint (:mod:`alphatpu_torch.checkpoint`).
"""
from __future__ import annotations

import dataclasses

import torch

from .parallel.mesh import all_reduce


@dataclasses.dataclass
class ReplayBuffer:
    state: torch.Tensor  # i8[cap, 2*VS]
    policy: torch.Tensor  # f32[cap, A]
    player: torch.Tensor  # i8[cap]
    value: torch.Tensor  # f32[cap]
    fstate: torch.Tensor  # i8[cap, fsize]
    cursor: torch.Tensor  # i32[1] - next write slot
    total: torch.Tensor  # i32[1] - total ever written

    @property
    def capacity(self) -> int:
        return self.state.shape[0]


def create_buffer(game, capacity: int, device=None) -> ReplayBuffer:
    return ReplayBuffer(
        state=torch.zeros((capacity, 2 * game.vectorized_state),
                          dtype=torch.int8, device=device),
        policy=torch.zeros((capacity, game.max_actions), dtype=torch.float32,
                           device=device),
        player=torch.zeros((capacity,), dtype=torch.int8, device=device),
        value=torch.zeros((capacity,), dtype=torch.float32, device=device),
        fstate=torch.zeros((capacity, game.feature_size), dtype=torch.int8,
                           device=device),
        cursor=torch.zeros((1,), dtype=torch.int32, device=device),
        total=torch.zeros((1,), dtype=torch.int32, device=device),
    )


def buffer_size(buffer: ReplayBuffer) -> torch.Tensor:
    """Number of valid samples in this (local) shard."""
    return torch.clamp_max(buffer.total[0], buffer.capacity)


def global_buffer_size(buffer: ReplayBuffer) -> int:
    """Host-side: the valid samples of every rank's shard (an all_reduce
    in a world of several ranks, so every rank calls it), this buffer's
    own in a world of one."""
    return int(all_reduce(buffer_size(buffer).reshape(1)))


def write_samples(buffer: ReplayBuffer, state, policy, player, value, fstate,
                  mask) -> ReplayBuffer:
    """Append the ``mask``-selected rows (flat leading axis N) to the ring
    in order, in place.  Of more rows than the capacity, the last
    ``capacity`` are kept, as ring order implies, so every slot is written
    by one kept row at most.

    Fixed-shape and sync-free, as the reference's out-of-bounds scatter
    (``alphatpu/buffer.py:65-84``): every one of the N rows is written.  A
    kept row goes to its slot; a dropped row (masked out, or older than
    the last ``capacity`` kept) writes, to a sink slot, what that slot
    holds after the write: where fewer than ``capacity`` rows are kept,
    slot ``(cursor + n) % capacity`` (no kept row lands there) its own
    row; else the last kept row's slot that row."""
    cap, N = buffer.capacity, mask.shape[0]
    if N == 0:
        return buffer
    cursor = buffer.cursor[0].to(torch.int64)
    offs = torch.cumsum(mask.to(torch.int64), 0) - 1
    n = offs[-1] + 1
    keep = mask & (offs >= n - cap)
    full = n >= cap
    sink = (cursor + n - full.to(torch.int64)) % cap
    slot = torch.where(keep, (cursor + offs) % cap, sink)
    last = torch.where(mask, torch.arange(N, device=mask.device), 0).amax()
    for plane, rows in ((buffer.state, state), (buffer.policy, policy),
                        (buffer.player, player), (buffer.value, value),
                        (buffer.fstate, fstate)):
        rows = rows.to(plane.dtype)
        fill = torch.where(full, rows.index_select(0, last.reshape(1)),
                           plane.index_select(0, sink.reshape(1)))
        kept = keep.reshape((N,) + (1,) * (rows.dim() - 1))
        plane.index_copy_(0, slot, torch.where(kept, rows, fill))
    buffer.cursor[0] = ((cursor + n) % cap).to(torch.int32)
    buffer.total[0] += n.to(torch.int32)
    return buffer


def sample_batch(buffer: ReplayBuffer, generator: torch.Generator | None,
                 batch_size: int, idx: torch.Tensor | None = None):
    """A batch drawn uniformly with replacement from the shard's valid
    rows ``[0, size)`` (row 0 of an empty buffer), as ``(state, policy, value,
    fstate)`` with the states and features as float32.  ``idx`` (i64[B])
    replaces the draw: the injection point of the tests."""
    if idx is None:
        size = max(int(buffer_size(buffer)), 1)
        idx = torch.randint(0, size, (batch_size,), generator=generator,
                            device=buffer.state.device)
    idx = idx.to(buffer.state.device).long()
    return (buffer.state[idx].to(torch.float32), buffer.policy[idx],
            buffer.value[idx], buffer.fstate[idx].to(torch.float32))
