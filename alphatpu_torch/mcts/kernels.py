"""The MCTS kernels of the port: packed-stat helpers, the two kernel
wrappers with their launch counters, and the plain torch version of each.

Counterpart of ``alphatpu/mcts/pallas_kernels.py``.  The rollout loop of
:func:`alphatpu_torch.mcts.search.run_mcts` calls two kernels, each written
by hand in CUDA C++ for Hopper (``alphatpu_torch/csrc/``):

* :func:`select_apply_packed` - once per rollout: apply the previous
  rollout's deferred prior-row write and backup adds to the packed
  ``(wsum | visits)`` plane, then walk every game from its root to a leaf
  (replaces ``pallas_kernels.select_apply_packed``),
* :func:`backup` - once per move: the f32 backup adds of the last rollout,
  the flush after the loop (replaces ``pallas_kernels.backup_pallas``).

Each wrapper runs its plain torch version (``*_plain``) when - and only
when - its tensors lie on the CPU; on CUDA tensors it launches the kernel
or raises.  ``launches`` on each wrapper counts the kernel launches.

Packed plane: one int32 word per edge, ``[round(wsum * S) u16 | visits
u16]`` with ``S = value_scale(R)``; leaf values are quantized to the 1/S
grid before they are backed up, so every sum is exact.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .newton import ALPHA_FLOOR, cdf_sample, row_sum, solve_alpha
from .tree import child_lookup

# ---------------------------------------------------------------------------
# packed (wsum | visits) helpers
# ---------------------------------------------------------------------------


def value_scale(rollouts: int) -> int:
    """Largest power-of-two S with rollouts * S < 2**16: the fixed-point
    scale of the packed wsum half."""
    s = 1
    while rollouts * (s * 2) < (1 << 16):
        s *= 2
    return s


def quantize_value(v: torch.Tensor, scale: int) -> torch.Tensor:
    """Round a leaf value in [0, 1] to the 1/scale grid (half to even)."""
    return torch.round(v * scale) * (1.0 / scale)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> the int32 with those bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_stats(wsum: torch.Tensor, visits: torch.Tensor, scale: int):
    """f32, f32 -> i32 ``[round(wsum * scale) u16 | visits u16]``."""
    wfix = torch.round(wsum * scale).to(torch.int64)
    return _as_int32((wfix << 16) | visits.to(torch.int64))


def unpack_wsum(packed: torch.Tensor, scale: int) -> torch.Tensor:
    """High half -> f32.  The high half may use bit 31, and torch's ``>>``
    on int32 is arithmetic, so the shifted word is masked to 16 bits."""
    fix = (packed >> 16) & 0xFFFF
    return fix.to(torch.float32) * (1.0 / scale)


def unpack_visits(packed: torch.Tensor) -> torch.Tensor:
    """Low half -> f32."""
    return (packed & 0xFFFF).to(torch.float32)


class PendingUpdate(NamedTuple):
    """One rollout's deferred stat writes, applied by the next rollout's
    :func:`select_apply_packed`."""

    nodes: torch.Tensor  # i32[D, G] - recorded path (backup targets)
    actions: torch.Tensor  # i32[D, G]
    length: torch.Tensor  # i32[G]
    value: torch.Tensor  # f32[G] - leaf value to back up
    leaf: torch.Tensor  # i32[G] - node whose prior row gets written
    newp: torch.Tensor  # f32[A, G] - the prior row
    write: torch.Tensor  # bool[G] - False = no prior write


def empty_pending(depth_cap: int, A: int, G: int, device=None) -> PendingUpdate:
    """The no-op pending update of the first rollout."""
    return PendingUpdate(
        nodes=torch.full((depth_cap, G), -1, dtype=torch.int32, device=device),
        actions=torch.zeros((depth_cap, G), dtype=torch.int32, device=device),
        length=torch.zeros((G,), dtype=torch.int32, device=device),
        value=torch.zeros((G,), dtype=torch.float32, device=device),
        leaf=torch.zeros((G,), dtype=torch.int32, device=device),
        newp=torch.zeros((A, G), dtype=torch.float32, device=device),
        write=torch.zeros((G,), dtype=torch.bool, device=device),
    )


class Selection(NamedTuple):
    """Result of one rollout's walk."""

    nodes: torch.Tensor  # i32[D, G] - node at each depth, -1 = none
    actions: torch.Tensor  # i32[D, G] - action taken, 0 where node is -1
    leaf: torch.Tensor  # i32[G] - final node (the leaf, or the parent of
    #                     the child to allocate)
    leaf_action: torch.Tensor  # i32[G]
    needs_alloc: torch.Tensor  # bool[G]
    root_pi: torch.Tensor  # f32[A, G] - the depth-0 policy


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def _path_contrib(length, value, d: int) -> torch.Tensor:
    """Parity-flipped leaf value for the edge at depth d: ``1 - v`` on the
    leaf edge and every second edge above it, ``v`` on the others."""
    k = length - 1 - d
    return torch.where(k % 2 == 0, 1.0 - value, value)


def node_policy_rows(P, Q, N, cpuct):
    """The walk's per-node policy on gathered rows ([A, G] each), in the
    kernel's arithmetic: a node with no visits returns its prior; the
    others run the latched Newton solve."""
    nvis = row_sum(N)
    n = 1.0 + nvis
    acts = row_sum((P > 0).to(torch.float32))
    lam = cpuct * torch.sqrt(n) / (acts + n)
    top = lam[None, :] * P
    alpha0 = torch.amax(Q + torch.clamp_min(top, ALPHA_FLOOR), dim=0)
    fresh = nvis == 0.0
    alpha = solve_alpha(top, Q, alpha0, fresh)
    return torch.where(fresh[None, :], P, top / (alpha[None, :] - Q))


def select_apply_packed_plain(prior, packed, parent, action_from, expanded,
                              probs, pend: PendingUpdate, cpuct: float,
                              scale: int) -> Selection:
    """Plain torch version of :func:`select_apply_packed` (same arguments,
    same in-place updates, same result), lockstep over games."""
    A, V, G = prior.shape
    D = probs.shape[0]
    g = torch.arange(G, device=prior.device)

    # pending prior-row write; leaf == V means a full tree: nothing to write
    w = pend.write & (pend.leaf < V)
    prior[:, pend.leaf.long()[w], g[w]] = pend.newp[:, w]

    # pending backup adds: one integer add of (contrib*S) << 16 | 1 per edge
    for d in range(pend.nodes.shape[0]):
        valid = pend.nodes[d] >= 0
        cfix = (_path_contrib(pend.length, pend.value, d) * scale
                ).to(torch.int64)
        idx = (pend.actions[d].long()[valid], pend.nodes[d].long()[valid],
               g[valid])
        packed[idx] = _as_int32(packed[idx].to(torch.int64)
                                + ((cfix[valid] << 16) + 1))

    # the walk
    nodes_out = torch.full((D, G), -1, dtype=torch.int32, device=prior.device)
    actions_out = torch.zeros((D, G), dtype=torch.int32, device=prior.device)
    node = torch.zeros((G,), dtype=torch.int32, device=prior.device)
    found = torch.zeros((G,), dtype=torch.bool, device=prior.device)
    leaf_action = torch.zeros_like(node)
    needs_alloc = torch.zeros_like(found)
    root_pi = None
    for d in range(D):
        if d > 0 and bool(found.all()):
            break
        n = node.long()
        exp = expanded[n, g]
        PK = packed[:, n, g]
        W = unpack_wsum(PK, scale)
        N = unpack_visits(PK)
        Q = torch.where(N > 0, W / torch.clamp_min(N, 1.0), 0.0)
        PI = node_policy_rows(prior[:, n, g], Q, N, cpuct)
        if d == 0:
            root_pi = PI
        action = cdf_sample(PI, probs[d])
        live = ~found & exp
        nodes_out[d] = torch.where(live, node, -1)
        actions_out[d] = torch.where(live, action, 0)
        cid = child_lookup(parent, action_from, node, action)
        hit_missing = live & (cid == 0)
        leaf_action = torch.where(hit_missing, action, leaf_action)
        needs_alloc = needs_alloc | hit_missing
        found = found | ~exp | hit_missing
        node = torch.where(live & (cid > 0), cid, node)
    return Selection(nodes_out, actions_out, node, leaf_action, needs_alloc,
                     root_pi)


def backup_plain(wsum, visits, nodes, actions, length, value) -> None:
    """Plain torch version of :func:`backup`: per recorded path edge,
    ``wsum += contrib`` and ``visits += 1`` in f32, in place."""
    G = wsum.shape[2]
    g = torch.arange(G, device=wsum.device)
    for d in range(nodes.shape[0]):
        valid = nodes[d] >= 0
        idx = (actions[d].long()[valid], nodes[d].long()[valid], g[valid])
        wsum[idx] = wsum[idx] + _path_contrib(length, value, d)[valid]
        visits[idx] = visits[idx] + 1.0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

MAX_ACTIONS = 169  # the kernels' per-thread row buffers (13x13 boards)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def select_apply_packed(prior, packed, parent, action_from, expanded, probs,
                        pend: PendingUpdate, cpuct: float,
                        scale: int) -> Selection:
    """Apply the previous rollout's deferred writes, then walk root to leaf.

    ``prior`` f32[A, V, G] and ``packed`` i32[A, V, G] are updated in place
    (the reference aliased them through the kernel); ``parent`` and
    ``action_from`` i32[V, G], ``expanded`` bool[V, G], ``probs`` f32[D, G]
    (one uniform per depth), ``pend`` the previous rollout's
    :class:`PendingUpdate`.  Returns the :class:`Selection`."""
    if prior.device.type == "cpu":
        return select_apply_packed_plain(prior, packed, parent, action_from,
                                         expanded, probs, pend, cpuct, scale)
    if prior.device.type != "cuda":
        raise ValueError(f"select_apply_packed: no kernel for {prior.device}")
    A, V, G = prior.shape
    D = probs.shape[0]
    dev = prior.device
    if not 1 <= A <= MAX_ACTIONS:
        raise ValueError(f"select_apply_packed: A={A} outside 1..{MAX_ACTIONS}")
    for name, t, dt, shape in (
        ("prior", prior, torch.float32, (A, V, G)),
        ("packed", packed, torch.int32, (A, V, G)),
        ("parent", parent, torch.int32, (V, G)),
        ("action_from", action_from, torch.int32, (V, G)),
        ("expanded", expanded, torch.bool, (V, G)),
        ("probs", probs, torch.float32, (D, G)),
        ("pend.nodes", pend.nodes, torch.int32, (D, G)),
        ("pend.actions", pend.actions, torch.int32, (D, G)),
        ("pend.length", pend.length, torch.int32, (G,)),
        ("pend.value", pend.value, torch.float32, (G,)),
        ("pend.leaf", pend.leaf, torch.int32, (G,)),
        ("pend.newp", pend.newp, torch.float32, (A, G)),
        ("pend.write", pend.write, torch.bool, (G,)),
    ):
        _check(name, t, dt, shape, dev)
    from .._build import load_library

    lib = load_library()
    out = Selection(
        nodes=torch.empty((D, G), dtype=torch.int32, device=dev),
        actions=torch.empty((D, G), dtype=torch.int32, device=dev),
        leaf=torch.empty((G,), dtype=torch.int32, device=dev),
        leaf_action=torch.empty((G,), dtype=torch.int32, device=dev),
        needs_alloc=torch.empty((G,), dtype=torch.bool, device=dev),
        root_pi=torch.empty((A, G), dtype=torch.float32, device=dev),
    )
    with torch.cuda.device(dev):
        err = lib.launch_select_apply_packed(
            _ptr(prior), _ptr(packed), _ptr(parent), _ptr(action_from),
            _ptr(expanded), _ptr(probs),
            _ptr(pend.nodes), _ptr(pend.actions), _ptr(pend.length),
            _ptr(pend.value), _ptr(pend.leaf), _ptr(pend.newp),
            _ptr(pend.write),
            _ptr(out.nodes), _ptr(out.actions), _ptr(out.leaf),
            _ptr(out.leaf_action), _ptr(out.needs_alloc), _ptr(out.root_pi),
            A, V, G, D, ctypes.c_float(cpuct), scale, _stream())
    _raise_on(err, "select_apply_packed launch")
    select_apply_packed.launches += 1
    return out


select_apply_packed.launches = 0


def backup(wsum, visits, nodes, actions, length, value) -> None:
    """Per recorded path edge, ``wsum += parity-flipped value`` and
    ``visits += 1`` (f32, in place).  wsum/visits f32[A, V, G], nodes and
    actions i32[D, G] (node -1 = nothing recorded), length i32[G], value
    f32[G]."""
    if wsum.device.type == "cpu":
        return backup_plain(wsum, visits, nodes, actions, length, value)
    if wsum.device.type != "cuda":
        raise ValueError(f"backup: no kernel for {wsum.device}")
    A, V, G = wsum.shape
    D = nodes.shape[0]
    dev = wsum.device
    for name, t, dt, shape in (
        ("wsum", wsum, torch.float32, (A, V, G)),
        ("visits", visits, torch.float32, (A, V, G)),
        ("nodes", nodes, torch.int32, (D, G)),
        ("actions", actions, torch.int32, (D, G)),
        ("length", length, torch.int32, (G,)),
        ("value", value, torch.float32, (G,)),
    ):
        _check(name, t, dt, shape, dev)
    from .._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.launch_backup(
            _ptr(wsum), _ptr(visits), _ptr(nodes), _ptr(actions),
            _ptr(length), _ptr(value), A, V, G, D, _stream())
    _raise_on(err, "backup launch")
    backup.launches += 1


backup.launches = 0


def reset_launch_counts() -> None:
    select_apply_packed.launches = 0
    backup.launches = 0
