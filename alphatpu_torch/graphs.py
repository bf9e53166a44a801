"""Every jitted search caller of the reference as one program: its steps
replayed from CUDA graphs.

Counterpart of the reference's jit wrappers - the module-level jitted
selfplay generations of ``alphatpu/pipeline.py:38-42`` (the buffer write
included), ``_duel_half_jit`` (``alphatpu/duel.py:98``), the bench's
jitted generation (``bench.py:114``), ``_vs_random_half``
(``alphatpu/eval.py:33``), ``eval_vs_probe``'s ``net_move`` and
``apply_moves`` (``alphatpu/probe.py:582-601``), the interactive
engine's ``choose_impl`` (``alphatpu/interactive.py:66-94``) and each
variant of ``benchmarks/ablate_rollout.py``.  XLA compiles such a
function once per shape and reruns it with new arguments; here each step
of a program - a move round, a call's tail, a probe ply's net move, an
interactive move, an ablation move - is captured once per key as a
``torch.cuda.CUDAGraph`` and replayed once per step.

A :class:`Rounds` holds the static state of a program - the tree, the
positions, the counters, the per-round records, the round index ``t`` (a
device scalar that the round increments) and the buffers of injected
uniforms - allocated once, and defines its steps: ``round(net)`` (one
round, in place) and whatever else the caller runs through :func:`step`,
each with fixed shapes and nothing that waits for the device.  The same
code runs eagerly on the CPU and, when a caller asks with
``captured=False``, on the card.

Captured steps (the default on the card):

* programs are cached by key (:func:`rounds_for`: what fixes the shapes
  and the captured code - game, lanes, rounds, rollouts, stat dtype,
  engine level, the caller's config, the nets' identities, device); the
  last :data:`CACHE_SIZE` are kept, so chained calls replay one graph;
* a step's first run in a program (a net's first round) runs eagerly on
  the capture stream - real work, which also copies the game's constants
  to the card, builds the kernel library, sets the kernels' shared-memory
  attributes and makes cuBLAS's handles - and is then captured (into a
  memory pool the program's graphs share); every later run replays that
  graph;
* the draws come from the program's own generator, registered with each
  graph: a call copies its generator's state in before its steps and
  back out after them (:func:`drawing`), so its stream continues as
  eager steps continue it;
* a capture calls the kernel wrappers but launches nothing: the counts
  they add are taken back out, and each replay adds them again, so the
  counters keep meaning launches (:mod:`alphatpu_torch.mcts.kernels`);
* a graph reads the nets' parameters, and every tensor it was captured
  on, by address: a change made in place (the learner's update) is seen
  by the next replay, and a step whose inputs or outputs are the
  caller's tensors is keyed by their addresses;
* a replayed step returns the tensors its capture returned, rewritten by
  every replay: a caller that hands them on copies them.

A capture or replay that fails raises; nothing falls back to eager.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from .mcts import kernels as K

CACHE_SIZE = 4  # programs kept; the least recently used goes first

# since the last reset_counts(): graphs captured, graphs replayed, the
# seconds the captures took (instantiation included), the captured graphs'
# nodes and the device memory reserved while they were captured
counts = {"captures": 0, "replays": 0, "capture_s": 0.0, "capture_nodes": 0,
          "capture_pool_bytes": 0}

_cache: "OrderedDict[tuple, Rounds]" = OrderedDict()
_streams: dict = {}


def reset_counts() -> None:
    counts.update(captures=0, replays=0, capture_s=0.0, capture_nodes=0,
                  capture_pool_bytes=0)


def use_graphs(captured: bool | None, device) -> bool:
    """Whether a call on ``device`` replays captured rounds: by default on
    a CUDA device, never on the CPU; ``captured=True`` elsewhere raises."""
    dev = torch.device(device)
    if captured is None:
        return dev.type == "cuda"
    if captured and dev.type != "cuda":
        raise ValueError(f"captured rounds need a CUDA device, not {dev}")
    return bool(captured)


def net_identity(net) -> tuple:
    """What a graph captured of ``net`` depends on: the module (and, for a
    ``functools.partial``, the function and every argument) by identity."""
    if isinstance(net, functools.partial):
        return (net_identity(net.func), tuple(map(id, net.args)),
                tuple(sorted((k, id(v)) for k, v in net.keywords.items())))
    return (id(net),)


class Graph(NamedTuple):
    """One captured step: a net's round, or another step of the program."""

    graph: torch.cuda.CUDAGraph
    launches: dict  # kernel launches of one replay (kernels.launch_counts)
    out: object  # what the step returned while it was captured


class Rounds:
    """Static state of a call's rounds.  A subclass allocates it (on
    ``device``) and defines :meth:`round`; draws come from
    ``self.generator``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.generator: torch.Generator | None = None
        self.graphs: dict = {}  # step identity (a net's for a round) -> Graph
        self.nets: tuple = ()  # the nets of the key, kept alive
        self._pool = None
        # the captured rounds' draws (each graph registers it)
        self._own = torch.Generator(device=self.device)

    def round(self, net) -> None:
        raise NotImplementedError


def rounds_for(key: tuple, nets, make: Callable[[], Rounds]) -> Rounds:
    """The cached program of ``key`` and ``nets`` (by identity, in any
    order), made by ``make()`` on a miss; the least recently used program
    beyond :data:`CACHE_SIZE` is dropped with its graphs."""
    full = (key, frozenset(net_identity(n) for n in nets))
    rounds = _cache.get(full)
    if rounds is not None:
        _cache.move_to_end(full)
        return rounds
    rounds = make()
    rounds.nets = tuple(nets)
    _cache[full] = rounds
    if len(_cache) > CACHE_SIZE:
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
        torch.cuda.empty_cache()
    return rounds


def clear_cache() -> None:
    _cache.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _streams:
        _streams[dev] = torch.cuda.Stream(device=dev)
    return _streams[dev]


def _default_generator(dev: torch.device) -> torch.Generator:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch.cuda.default_generators[index]


@contextlib.contextmanager
def drawing(rounds: Rounds, generator: torch.Generator | None,
            captured: bool):
    """The steps run inside draw from ``generator`` (None: the device's
    default).  Captured: from the program's own generator, which takes
    ``generator``'s state on entry and hands it back on exit, so the
    caller's stream continues as eager steps continue it."""
    if not captured:
        rounds.generator = generator
        yield
        return
    outer = (generator if generator is not None
             else _default_generator(rounds.device))
    own = rounds._own
    own.set_state(outer.get_state())
    rounds.generator = own
    yield
    outer.set_state(own.get_state())


def step(rounds: Rounds, ident, fn: Callable[[], object],
         captured: bool):
    """One step ``fn()`` of ``rounds`` (inside :func:`drawing`); returns
    what ``fn`` returns.  Captured: the first step of ``ident`` runs
    eagerly on the capture stream and is then captured; every later one
    replays that graph and returns the tensors the capture returned,
    rewritten in place (a caller that hands them on copies them)."""
    if not captured:
        return fn()
    graph = rounds.graphs.get(ident)
    if graph is None:
        stream = _capture_stream(rounds.device)
        out = _eager_on(stream, rounds.device, fn)
        rounds.graphs[ident] = _capture(rounds, fn, stream)
        return out
    graph.graph.replay()
    K.add_launches(graph.launches)
    counts["replays"] += 1
    return graph.out


def play(rounds: Rounds, T: int, net_of: Callable[[int], Callable],
         generator: torch.Generator | None,
         feed: Callable[[int], None] | None = None,
         captured: bool = False) -> None:
    """Run ``T`` rounds of ``rounds``: round ``t`` with the net
    ``net_of(t)``, after ``feed(t)`` has copied its injected inputs into
    the static buffers; each round a :func:`step` keyed by its net."""
    with drawing(rounds, generator, captured):
        for t in range(T):
            if feed is not None:
                feed(t)
            net = net_of(t)
            step(rounds, net_identity(net),
                 functools.partial(rounds.round, net), captured)


def _eager_on(stream: torch.cuda.Stream, dev: torch.device, fn):
    """``fn()`` on ``stream``, ordered after and before the work of the
    current stream."""
    current = torch.cuda.current_stream(dev)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


def _capture(rounds: Rounds, fn, stream: torch.cuda.Stream) -> Graph:
    """Capture one step ``fn()`` of ``rounds`` and instantiate it."""
    dev = rounds.device
    if rounds._pool is None:
        rounds._pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.register_generator_state(rounds.generator)
    before = K.launch_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=rounds._pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
    finally:
        after = K.launch_counts()
        K.set_launch_counts(before)
    graph.instantiate()
    counts["captures"] += 1
    counts["capture_s"] += time.perf_counter() - t0
    counts["capture_nodes"] += graph_nodes(graph)
    counts["capture_pool_bytes"] += torch.cuda.memory_reserved(dev) - reserved
    return Graph(graph, {k: (after[k][0] - before[k][0],
                             after[k][1] - before[k][1]) for k in after},
                 out)


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a captured graph (``cuGraphGetNodes`` of libcuda)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = get_nodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUresult {err}")
    return n.value


def addresses(*tensors) -> tuple:
    """What a graph that reads or writes ``tensors`` by address depends
    on: each one's address, shape, strides and dtype."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


def copied(out):
    """``out`` (a tensor, or tuples, named tuples and dicts of them) with
    every tensor copied: a replayed step's outputs handed to a caller."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: copied(v) for k, v in out.items()}
    if isinstance(out, tuple):
        items = [copied(v) for v in out]
        return type(out)(*items) if hasattr(out, "_fields") else tuple(items)
    return out


def assign(dst, src) -> None:
    """Copy the leaves of state ``src`` into those of ``dst``, in place."""
    for d, s in zip(dst, src):
        d.copy_(s)
