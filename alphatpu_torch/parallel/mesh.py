"""The data-parallel world: one process per rank over ``torch.distributed``.

Counterpart of ``make_mesh``, ``device_keys`` and ``_psum_stats``
(alphatpu/parallel/mesh.py:31-61).  The reference drives D devices from
one controller through a 1-axis ``dp`` mesh; here each rank is a process
that owns one device (PyTorch's idiom), and the ranks meet in one process
group:

* :func:`make_world` starts or joins the group and gives the rank its
  device: ``nccl`` where each rank owns a card, ``gloo`` on the CPU.  Ranks
  that share one card need ``gloo``, which only a caller asks for (the
  CLI has no backend flag, as the reference has none),
* :func:`rank_generator` is ``device_keys``: every rank draws the same D
  seeds from the run's shared generator and takes its own, so the ranks'
  streams are distinct and deterministic and the shared stream stays in
  step on every rank,
* :func:`all_reduce` and :func:`all_gather` are the only collectives the
  port calls (:func:`barrier` is an all_reduce).  Gloo takes CUDA
  tensors for few operations, so on gloo a CUDA tensor goes through the
  host; the collective itself always runs,
* :func:`psum_stats` sums selfplay's stats over the ranks,
* :func:`run_ranks` spawns the ranks of one host and returns their
  results (the CLI's ``--devices D``, the dry run and the tests).

A process that joined no group is a world of one rank: every collective
returns its input.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple

import torch
import torch.distributed as dist

from .. import resolve_device


class World(NamedTuple):
    rank: int
    size: int
    device: torch.device  # the rank's own device


def world_size() -> int:
    """Ranks in this process's group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def world_devices(num_devices: int, device) -> int:
    """The ranks ``--devices num_devices`` asks for: ``num_devices``, or
    for 0 every visible card (one rank on the CPU or on a named card).
    Raises where several ranks, one card each, need more cards than this
    host shows."""
    dev = torch.device(device)
    one_each = dev.type == "cuda" and dev.index is None
    if not num_devices:
        return max(visible_cards(), 1) if one_each else 1
    n = visible_cards()
    if num_devices > 1 and one_each and n < num_devices:
        names = [torch.cuda.get_device_name(i) for i in range(n)]
        raise ValueError(
            f"--devices {num_devices} requested but only {n} CUDA "
            f"device(s) visible ({names}); for CPU ranks (gloo) pass "
            f"--device cpu, for multi-host pass --multihost")
    return num_devices


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_init_method() -> str:
    """A ``tcp://localhost`` rendezvous on a port that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return f"tcp://localhost:{port}"


def make_world(size: int, device, *, rank: int | None = None,
               backend: str | None = None,
               init_method: str | None = None) -> World:
    """Start or join the process group of ``size`` ranks (as
    :func:`world_devices` resolves them) and return this rank's
    :class:`World`.

    ``rank`` and ``init_method`` default to torchrun's ``RANK`` and
    ``env://``.  The rank's device: ``device`` itself on the CPU or where
    it names a card (every rank on that card, which needs ``backend=
    "gloo"``), else the card ``LOCAL_RANK`` (torchrun's), or the rank
    modulo the visible cards.  One rank and no ``init_method``:
    no group, the single-device path."""
    dev = torch.device(device)
    if size == 1 and init_method is None:
        return World(0, 1, resolve_device(dev))
    if rank is None:
        rank = int(os.environ["RANK"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % max(visible_cards(), 1))))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=init_method or "env://",
                            world_size=size, rank=rank)
    return World(rank, size, dev)


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it as it is (contiguous, on the host
    for gloo, on the rank's card for nccl, not bool), else a copy that
    is: bool as uint8."""
    dev = (torch.device("cpu") if dist.get_backend() == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
    return t.to(device=dev, dtype=dtype).contiguous()


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place and return it (``t`` as it is in
    a process that joined no group).  The caller passes a tensor it owns;
    on nccl a contiguous tensor on the card is reduced where it lies."""
    if not dist.is_initialized():
        return t
    buf = _on_backend(t)
    dist.all_reduce(buf)
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), by rank, on ``t``'s device."""
    if not dist.is_initialized():
        return [t]
    buf = _on_backend(t)
    out = [torch.empty_like(buf) for _ in range(world_size())]
    dist.all_gather(out, buf)
    return [o.to(device=t.device, dtype=t.dtype) for o in out]


def barrier() -> None:
    """Wait until every rank is here (an all_reduce of one element)."""
    all_reduce(torch.zeros(1))


def rank_generator(generator: torch.Generator,
                   world: World) -> torch.Generator:
    """This rank's stream, the counterpart of ``device_keys``: every rank
    draws the same ``world.size`` seeds from the shared ``generator`` and
    seeds a new generator on its device with its own."""
    seeds = torch.randint(0, 2 ** 62, (world.size,), generator=generator,
                          device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(
        int(seeds[world.rank]))


def psum_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Selfplay's stats (0-d tensors) summed over the ranks in one
    all_reduce; ``mean_length`` is weighted by each rank's finished games
    (wins + draws + losses), as alphatpu/parallel/mesh.py:50-63 weighs
    it."""
    if not dist.is_initialized():
        return stats
    finished = stats["wins"] + stats["draws"] + stats["losses"]
    length_sum = stats["mean_length"] * finished.to(torch.float32)
    keys = [k for k in stats if k != "mean_length"]
    # float64 holds every count exactly and a sum of two float32 values
    # rounds to the float32 sum
    total = all_reduce(torch.stack(
        [stats[k].to(torch.float64) for k in keys]
        + [length_sum.to(torch.float64)]))
    summed = {k: total[i].to(stats[k].dtype) for i, k in enumerate(keys)}
    fin = summed["wins"] + summed["draws"] + summed["losses"]
    mean_length = total[-1].to(torch.float32) / torch.clamp_min(
        fin, 1).to(torch.float32)
    return {k: mean_length if k == "mean_length" else summed[k]
            for k in stats}


def _rank_main(fn, rank, size, device, backend, init_method, args,
               results) -> None:
    try:
        world = make_world(size, device, rank=rank, backend=backend,
                           init_method=init_method)
        try:
            value = fn(world, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # the parent reports it and stops the other ranks
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable[..., Any], num_devices: int, *args,
              device="cuda", backend: str | None = None,
              init_method: str | None = None,
              timeout: float | None = None) -> List[Any]:
    """``fn(world, *args)`` in ``num_devices`` new processes of this host,
    one per rank, joined in one group; returns their results by rank.

    ``device`` is where the ranks run: one card each (``"cuda"``), every
    rank on one named card, or the CPU (``"cpu"``, gloo).  ``fn``,
    ``args`` and the results are pickled: a module-level function, and
    results on the host.  ``init_method`` defaults to a free
    ``tcp://localhost`` port.  A rank that raises, or a run that outlasts
    ``timeout`` seconds, raises here after every rank is stopped."""
    world_devices(num_devices, device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = init_method or free_init_method()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, num_devices, str(device), backend, init_method, args,
        results)) for r in range(num_devices)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    out: Dict[int, Any] = {}
    try:
        while len(out) < num_devices:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                died = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if died:
                    raise RuntimeError(f"rank(s) {died} died with exit "
                                       f"code(s) "
                                       f"{[procs[r].exitcode for r in died]}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{num_devices} ranks did not finish "
                                       f"in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == num_devices else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(num_devices)]
