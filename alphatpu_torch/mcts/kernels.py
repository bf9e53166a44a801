"""The MCTS kernels of the port: packed-stat helpers, the kernel wrappers
with their launch counters, and the plain torch version of each.

Counterpart of ``alphatpu/mcts/pallas_kernels.py``.  Five kernels, each
written by hand in CUDA C++ for Hopper (``alphatpu_torch/csrc/``):

* :func:`select_apply_packed` - the level-1 engine, once per rollout:
  apply the previous rollout's deferred prior-row write and backup adds to
  the packed ``(wsum | visits)`` plane, then walk every game from its root
  to a leaf (replaces ``pallas_kernels.select_apply_packed``),
* :func:`select_apply_packed1` - the level-2 engine: the same on the
  1-plane ``(prior | wsum | visits)`` word (replaces
  ``pallas_kernels.select_apply_packed1``),
* :func:`select_apply` - the level-0 engine: the same on three stat
  planes, with unquantized values (replaces
  ``pallas_kernels.select_apply_pallas``),
* :func:`select` - the read-only walk over three stat planes, behind the
  per-phase search API (replaces ``pallas_kernels.select_pallas``),
* :func:`backup` - the backup adds of a recorded path: the flush after
  every engine's rollout loop (replaces ``pallas_kernels.backup_pallas``).

The three-plane kernels (:func:`select_apply`, :func:`select`,
:func:`backup`) take f32 planes or, under ``ALPHATPU_BF16_STATS``
(``tree.stat_dtype_for``), bf16 planes - one instantiation of each kernel
per storage dtype, as the reference sized its blocks by the planes'
itemsize.  Rows are read as f32; each backup add runs in f32 and is
rounded once to the storage dtype, and so is each entry of a written
prior row (round to nearest even); an untouched element round-trips
exactly.  ``launches`` counts a wrapper's launches of either dtype,
``launches_bf16`` those on bf16 planes; a replayed CUDA graph adds the
launches its capture recorded (:mod:`alphatpu_torch.graphs`).  The game
rules' three kernel wrappers (:mod:`alphatpu_torch.games.kernels`) join
this accounting: :data:`KERNELS` and the counters name them too.

The four walks share one CUDA header (``csrc/walk.cuh``) and one plain
walk (:func:`_walk_plain`); they differ in how a node's row is loaded.
Each walks every game with a group of lanes of a warp (``walk_group``,
launch geometry from :func:`walk_geometry`, which places a tree of any
size: its columns in shared memory, or in device memory where they do
not fit); :func:`backup` runs one thread per path depth and game
(:func:`backup_geometry`).  Each
wrapper runs its plain torch version (``*_plain``) when - and only when -
its tensors lie on the CPU; on CUDA tensors it launches the kernel or
raises.

Packed plane (level 1): one int32 word per edge, ``[round(wsum * S) u16 |
visits u16]`` with ``S = value_scale(R)``.  1-plane word (level 2):
``[prior u11 | wsum * S1 | visits]`` per :func:`packed1_layout`.  Leaf
values are quantized to the 1/S grid (and at level 2 prior rows to the
1/2048 grid) before they are stored, so every sum is exact.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import launch as _launch
from .._build import on_cuda as _on_cuda
from ..games.kernels import RULES
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


# ---------------------------------------------------------------------------
# 1-plane (prior | wsum | visits) helpers
# ---------------------------------------------------------------------------

PRIOR_BITS = 11
_PRIOR_GRID = float(1 << PRIOR_BITS)


class Packed1Layout(NamedTuple):
    """Field sizes of the 1-plane word ``[prior u11 | wsum * scale
    u(bits_w) | visits u(bits_v)]``."""

    bits_v: int
    bits_w: int
    scale: int


def packed1_layout(rollouts: int) -> Packed1Layout:
    """The 1-plane word of an R-rollout search: the visits field holds R,
    the wsum field gets the rest below the prior, and ``scale`` is the
    largest power of two with R * scale inside the wsum field."""
    bits_v = max(1, int(rollouts).bit_length())
    bits_w = 32 - PRIOR_BITS - bits_v
    if bits_w < 8:
        raise ValueError(f"rollouts={rollouts} leaves {bits_w} < 8 wsum "
                         "bits in the 1-plane word")
    s = 1
    while rollouts * (s * 2) < (1 << bits_w):
        s *= 2
    return Packed1Layout(bits_v, bits_w, s)


def quantize_prior(p: torch.Tensor) -> torch.Tensor:
    """Round a prior in [0, 1] to the 1/2048 grid (half to even), clamped
    to 2047/2048 so that 1.0 fits the u11 field."""
    return (torch.clamp_max(torch.round(p * _PRIOR_GRID), _PRIOR_GRID - 1.0)
            * (1.0 / _PRIOR_GRID))


def _prior_fix(p: torch.Tensor) -> torch.Tensor:
    """The u11 prior field of ``p`` as int64."""
    return torch.clamp_max(torch.round(p * _PRIOR_GRID),
                           _PRIOR_GRID - 1.0).to(torch.int64)


def pack1_stats(prior, wsum, visits, layout: Packed1Layout) -> torch.Tensor:
    """f32 x3 -> i32 ``[prior u11 | wsum fix | visits]``; lossless for
    on-grid prior and wsum and integer visits."""
    bits_v, bits_w, s = layout
    wfix = torch.round(wsum * s).to(torch.int64)
    return _as_int32((_prior_fix(prior) << (bits_v + bits_w))
                     | (wfix << bits_v) | visits.to(torch.int64))


def unpack1_prior(packed: torch.Tensor, layout: Packed1Layout):
    """Top 11 bits -> f32 (masked: torch's ``>>`` on int32 is
    arithmetic, and the field uses bit 31)."""
    fix = (packed >> (layout.bits_v + layout.bits_w)) & ((1 << PRIOR_BITS) - 1)
    return fix.to(torch.float32) * (1.0 / _PRIOR_GRID)


def unpack1_wsum(packed: torch.Tensor, layout: Packed1Layout):
    fix = (packed >> layout.bits_v) & ((1 << layout.bits_w) - 1)
    return fix.to(torch.float32) * (1.0 / layout.scale)


def unpack1_visits(packed: torch.Tensor, layout: Packed1Layout):
    return (packed & ((1 << layout.bits_v) - 1)).to(torch.float32)


class PendingUpdate(NamedTuple):
    """One rollout's deferred stat writes, applied by the next rollout's
    select_apply kernel."""

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


def _walk_plain(load_rows, parent, action_from, expanded, probs,
                cpuct: float) -> Selection:
    """Plain version of the CUDA walk (``csrc/walk.cuh``), lockstep over
    games.  ``load_rows(n, g)`` returns the (prior, wsum, visits) f32 rows
    [A, G] of node ``n[g]`` of each game."""
    D, G = probs.shape
    dev = probs.device
    g = torch.arange(G, device=dev)
    nodes_out = torch.full((D, G), -1, dtype=torch.int32, device=dev)
    actions_out = torch.zeros((D, G), dtype=torch.int32, device=dev)
    node = torch.zeros((G,), dtype=torch.int32, device=dev)
    found = torch.zeros((G,), dtype=torch.bool, device=dev)
    leaf_action = torch.zeros_like(node)
    needs_alloc = torch.zeros_like(found)
    root_pi = None
    for d in range(D):
        if d > 0 and bool(found.all()):
            break
        n = node.long()
        exp = expanded[n, g]
        P, W, N = load_rows(n, g)
        Q = torch.where(N > 0, W / torch.clamp_min(N, 1.0), 0.0)
        PI = node_policy_rows(P, Q, N, cpuct)
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


def _write_rows(plane, pend: PendingUpdate, rows) -> None:
    """The pending prior-row write: ``rows`` [A, G] at each writing lane's
    leaf, in place, rounded once to the plane's dtype; leaf == V means a
    full tree: nothing to write."""
    V, G = plane.shape[1], plane.shape[2]
    g = torch.arange(G, device=plane.device)
    w = pend.write & (pend.leaf < V)
    plane[:, pend.leaf.long()[w], g[w]] = rows[:, w].to(plane.dtype)


def _add_paths_packed(packed, pend: PendingUpdate, scale: int,
                      wshift: int) -> None:
    """The pending backup adds on a packed plane, in place: one integer
    add of ``(contrib * scale) << wshift | 1`` per edge, folded back to the
    int32 bit pattern."""
    g = torch.arange(packed.shape[2], device=packed.device)
    for d in range(pend.nodes.shape[0]):
        valid = pend.nodes[d] >= 0
        cfix = (_path_contrib(pend.length, pend.value, d) * scale
                ).to(torch.int64)
        idx = (pend.actions[d].long()[valid], pend.nodes[d].long()[valid],
               g[valid])
        packed[idx] = _as_int32(packed[idx].to(torch.int64)
                                + ((cfix[valid] << wshift) + 1))


def select_apply_packed_plain(prior, packed, parent, action_from, expanded,
                              probs, pend: PendingUpdate, cpuct: float,
                              scale: int) -> Selection:
    """Plain torch version of :func:`select_apply_packed` (same arguments,
    same in-place updates, same result)."""
    _write_rows(prior, pend, pend.newp)
    _add_paths_packed(packed, pend, scale, 16)

    def rows(n, g):
        pk = packed[:, n, g]
        return prior[:, n, g], unpack_wsum(pk, scale), unpack_visits(pk)

    return _walk_plain(rows, parent, action_from, expanded, probs, cpuct)


def select_apply_packed1_plain(packed, parent, action_from, expanded, probs,
                               pend: PendingUpdate, cpuct: float,
                               layout: Packed1Layout) -> Selection:
    """Plain torch version of :func:`select_apply_packed1`: the pending row
    overwrites whole words (quantized prior, zero stats)."""
    bits_v, bits_w, s = layout
    _write_rows(packed, pend,
                _as_int32(_prior_fix(pend.newp) << (bits_v + bits_w)))
    _add_paths_packed(packed, pend, s, bits_v)

    def rows(n, g):
        pk = packed[:, n, g]
        return (unpack1_prior(pk, layout), unpack1_wsum(pk, layout),
                unpack1_visits(pk, layout))

    return _walk_plain(rows, parent, action_from, expanded, probs, cpuct)


def select_apply_plain(prior, wsum, visits, parent, action_from, expanded,
                       probs, pend: PendingUpdate, cpuct: float) -> Selection:
    """Plain torch version of :func:`select_apply`: f32 adds of the
    unquantized value, one per edge, each rounded to the planes' dtype."""
    _write_rows(prior, pend, pend.newp)
    backup_plain(wsum, visits, pend.nodes, pend.actions, pend.length,
                 pend.value)
    return select_plain(prior, wsum, visits, parent, action_from, expanded,
                        probs, cpuct)


def select_plain(prior, wsum, visits, parent, action_from, expanded, probs,
                 cpuct: float) -> Selection:
    """Plain torch version of :func:`select`: the read-only walk, on rows
    read as f32."""
    return _walk_plain(
        lambda n, g: (prior[:, n, g].float(), wsum[:, n, g].float(),
                      visits[:, n, g].float()),
        parent, action_from, expanded, probs, cpuct)


def backup_plain(wsum, visits, nodes, actions, length, value) -> None:
    """Plain torch version of :func:`backup`: per recorded path edge,
    ``wsum += contrib`` and ``visits += 1`` in f32, each rounded once to
    the planes' dtype, in place."""
    G = wsum.shape[2]
    g = torch.arange(G, device=wsum.device)
    for d in range(nodes.shape[0]):
        valid = nodes[d] >= 0
        idx = (actions[d].long()[valid], nodes[d].long()[valid], g[valid])
        contrib = _path_contrib(length, value, d)[valid]
        wsum[idx] = (wsum[idx].float() + contrib).to(wsum.dtype)
        visits[idx] = (visits[idx].float() + 1.0).to(visits.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

MAX_ACTIONS = 169  # 13x13 boards: the row buffers of the kernels
NUM_SMS = 132  # an H100 SXM's streaming multiprocessors
_GROUP_THREADS = 128  # walk.cuh: kGroupThreads
_BACKUP_THREADS = 256  # backup.cu: kBackupThreads
_DEFAULT_SMEM = 48 * 1024  # dynamic shared memory without an opt-in
_MAX_SMEM = 232448  # what a block can use on sm_90
# where the cooperative walk's child lookup reads a game's parent and
# action_from columns (walk.cuh: kSharedColumns, kDeviceColumns)
SHARED_COLUMNS = 0  # copied into the block's shared memory
DEVICE_COLUMNS = 1  # read from the [V, G] planes in device memory


class WalkGeometry(NamedTuple):
    """Launch geometry of the cooperative walk (``walk_group``)."""

    lanes: int  # lanes per game: a power of two up to 32
    slots: int  # actions each lane holds: ceil(A / lanes), at most 6
    threads: int  # per block: 32, 64 or 128
    blocks: int
    smem: int  # bytes of shared memory per block: the games' columns
    placement: int  # SHARED_COLUMNS, or DEVICE_COLUMNS with smem 0


def column_words(V: int, lanes: int) -> int:
    """walk.cuh's column_words: one game's parent and action_from columns
    in shared memory, padded so that a warp's reads hit distinct banks."""
    return -(-2 * V // 32) * 32 + lanes


def walk_geometry(A: int, G: int, V: int) -> WalkGeometry:
    """Lanes per game: the next power of two of A, capped at 32, so each
    lane holds ceil(A / lanes) actions.  Blocks of 128 threads, halved
    down to one warp while that leaves SMs without a block or the games'
    columns above 48 KB of shared memory.  Where the columns of one warp's
    games exceed a block's shared memory, the device placement: the lookup
    reads them from device memory, and the block asks for none."""
    if not 1 <= A <= MAX_ACTIONS:
        raise ValueError(f"walk_geometry: A={A} outside 1..{MAX_ACTIONS}")
    if G < 1 or V < 1:
        raise ValueError(f"walk_geometry: G={G}, V={V}")
    lanes = min(32, 1 << (A - 1).bit_length())

    def smem(threads):
        return threads // lanes * column_words(V, lanes) * 4

    shared = smem(32) <= _MAX_SMEM
    threads = _GROUP_THREADS
    while threads > 32 and (-(-G * lanes // threads) < NUM_SMS
                            or (shared and smem(threads) > _DEFAULT_SMEM)):
        threads //= 2
    return WalkGeometry(lanes, -(-A // lanes), threads,
                        -(-G // (threads // lanes)),
                        smem(threads) if shared else 0,
                        SHARED_COLUMNS if shared else DEVICE_COLUMNS)


class BackupGeometry(NamedTuple):
    """Launch geometry of ``backup``: one thread per (depth, game)."""

    threads: int  # per block, along the games
    blocks: int  # along the games; the grid's second axis is the depth


def backup_geometry(G: int) -> BackupGeometry:
    if G < 1:
        raise ValueError(f"backup_geometry: G={G} < 1")
    threads = min(_BACKUP_THREADS, -(-G // 32) * 32)
    return BackupGeometry(threads, -(-G // threads))


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


def _check_walk(kernel, planes, parent, action_from, expanded, probs,
                pend=None):
    """Validate a walk kernel's arguments against the first stat plane's
    [A, V, G] and probs' D.  ``planes``: (name, tensor, dtype) of each stat
    plane.  Returns (A, V, G, D)."""
    A, V, G = planes[0][1].shape
    D = probs.shape[0]
    dev = planes[0][1].device
    if not 1 <= A <= MAX_ACTIONS:
        raise ValueError(f"{kernel}: A={A} outside 1..{MAX_ACTIONS}")
    specs = [(name, t, dt, (A, V, G)) for name, t, dt in planes] + [
        ("parent", parent, torch.int32, (V, G)),
        ("action_from", action_from, torch.int32, (V, G)),
        ("expanded", expanded, torch.bool, (V, G)),
        ("probs", probs, torch.float32, (D, G)),
    ]
    if pend is not None:
        specs += [
            ("pend.nodes", pend.nodes, torch.int32, (D, G)),
            ("pend.actions", pend.actions, torch.int32, (D, G)),
            ("pend.length", pend.length, torch.int32, (G,)),
            ("pend.value", pend.value, torch.float32, (G,)),
            ("pend.leaf", pend.leaf, torch.int32, (G,)),
            ("pend.newp", pend.newp, torch.float32, (A, G)),
            ("pend.write", pend.write, torch.bool, (G,)),
        ]
    for name, t, dt, shape in specs:
        _check(f"{kernel}: {name}", t, dt, shape, dev)
    return A, V, G, D


def _selection_out(A, G, D, dev) -> Selection:
    return Selection(
        nodes=torch.empty((D, G), dtype=torch.int32, device=dev),
        actions=torch.empty((D, G), dtype=torch.int32, device=dev),
        leaf=torch.empty((G,), dtype=torch.int32, device=dev),
        leaf_action=torch.empty((G,), dtype=torch.int32, device=dev),
        needs_alloc=torch.empty((G,), dtype=torch.bool, device=dev),
        root_pi=torch.empty((A, G), dtype=torch.float32, device=dev),
    )


# the storage dtypes of the three-plane kernels -> their entry's suffix
STAT_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def stat_dtype(kernel: str, *planes: torch.Tensor) -> torch.dtype:
    """The one dtype of a three-plane kernel's stat planes, f32 or bf16;
    mixed or other dtypes raise."""
    dtypes = {t.dtype for t in planes}
    if len(dtypes) != 1 or not dtypes <= STAT_DTYPES.keys():
        raise ValueError(f"{kernel}: stat planes of dtypes "
                         f"{sorted(map(str, dtypes))}: expected all f32 or "
                         "all bf16")
    return dtypes.pop()


def _count(kernel, dtype: torch.dtype) -> None:
    kernel.launches += 1
    kernel.launches_bf16 += dtype == torch.bfloat16


def select_apply_packed(prior, packed, parent, action_from, expanded, probs,
                        pend: PendingUpdate, cpuct: float,
                        scale: int) -> Selection:
    """Apply the previous rollout's deferred writes, then walk root to leaf.

    ``prior`` f32[A, V, G] and ``packed`` i32[A, V, G] are updated in place
    (the reference aliased them through the kernel); ``parent`` and
    ``action_from`` i32[V, G], ``expanded`` bool[V, G], ``probs`` f32[D, G]
    (one uniform per depth), ``pend`` the previous rollout's
    :class:`PendingUpdate`.  Returns the :class:`Selection`."""
    if not _on_cuda("select_apply_packed", prior):
        return select_apply_packed_plain(prior, packed, parent, action_from,
                                         expanded, probs, pend, cpuct, scale)
    A, V, G, D = _check_walk(
        "select_apply_packed",
        (("prior", prior, torch.float32), ("packed", packed, torch.int32)),
        parent, action_from, expanded, probs, pend)
    geometry = walk_geometry(A, G, V)
    out = _selection_out(A, G, D, prior.device)
    _launch("launch_select_apply_packed", prior.device, prior, packed,
            parent, action_from, expanded, probs, *pend, *out, A, V, G, D,
            ctypes.c_float(cpuct), scale, *geometry)
    select_apply_packed.launches += 1
    return out


def select_apply_packed1(packed, parent, action_from, expanded, probs,
                         pend: PendingUpdate, cpuct: float,
                         layout: Packed1Layout) -> Selection:
    """:func:`select_apply_packed` on the 1-plane word: ``packed``
    i32[A, V, G] (``[prior u11 | wsum | visits]`` per ``layout``) is
    updated in place; the pending row is written quantized, with zero
    stats."""
    if not _on_cuda("select_apply_packed1", packed):
        return select_apply_packed1_plain(packed, parent, action_from,
                                          expanded, probs, pend, cpuct,
                                          layout)
    A, V, G, D = _check_walk(
        "select_apply_packed1", (("packed", packed, torch.int32),),
        parent, action_from, expanded, probs, pend)
    geometry = walk_geometry(A, G, V)
    out = _selection_out(A, G, D, packed.device)
    _launch("launch_select_apply_packed1", packed.device, packed, parent,
            action_from, expanded, probs, *pend, *out, A, V, G, D,
            ctypes.c_float(cpuct), *layout, *geometry)
    select_apply_packed1.launches += 1
    return out


def select_apply(prior, wsum, visits, parent, action_from, expanded, probs,
                 pend: PendingUpdate, cpuct: float) -> Selection:
    """:func:`select_apply_packed` on three stat planes ``prior``, ``wsum``
    and ``visits`` [A, V, G], all f32 or all bf16 (updated in place), with
    the pending value backed up as it is (no quantization)."""
    dt = stat_dtype("select_apply", prior, wsum, visits)
    if not _on_cuda("select_apply", prior):
        return select_apply_plain(prior, wsum, visits, parent, action_from,
                                  expanded, probs, pend, cpuct)
    A, V, G, D = _check_walk(
        "select_apply", (("prior", prior, dt), ("wsum", wsum, dt),
                         ("visits", visits, dt)),
        parent, action_from, expanded, probs, pend)
    geometry = walk_geometry(A, G, V)
    out = _selection_out(A, G, D, prior.device)
    _launch("launch_select_apply" + STAT_DTYPES[dt], prior.device, prior,
            wsum, visits, parent, action_from, expanded, probs, *pend, *out,
            A, V, G, D, ctypes.c_float(cpuct), *geometry)
    _count(select_apply, dt)
    return out


def select(prior, wsum, visits, parent, action_from, expanded, probs,
           cpuct: float) -> Selection:
    """The read-only walk over three stat planes [A, V, G], all f32 or all
    bf16: every game from its root to a leaf."""
    dt = stat_dtype("select", prior, wsum, visits)
    if not _on_cuda("select", prior):
        return select_plain(prior, wsum, visits, parent, action_from,
                            expanded, probs, cpuct)
    A, V, G, D = _check_walk(
        "select", (("prior", prior, dt), ("wsum", wsum, dt),
                   ("visits", visits, dt)),
        parent, action_from, expanded, probs)
    geometry = walk_geometry(A, G, V)
    out = _selection_out(A, G, D, prior.device)
    _launch("launch_select" + STAT_DTYPES[dt], prior.device, prior, wsum,
            visits, parent, action_from, expanded, probs, *out, A, V, G, D,
            ctypes.c_float(cpuct), *geometry)
    _count(select, dt)
    return out


def backup(wsum, visits, nodes, actions, length, value) -> None:
    """Per recorded path edge, ``wsum += parity-flipped value`` and
    ``visits += 1`` (in f32, rounded once to the planes' dtype, in place).
    wsum/visits [A, V, G], both f32 or both bf16; nodes and actions
    i32[D, G] (node -1 = nothing recorded), length i32[G], value f32[G]."""
    dt = stat_dtype("backup", wsum, visits)
    if not _on_cuda("backup", wsum):
        return backup_plain(wsum, visits, nodes, actions, length, value)
    A, V, G = wsum.shape
    D = nodes.shape[0]
    dev = wsum.device
    for name, t, want, shape in (
        ("wsum", wsum, dt, (A, V, G)),
        ("visits", visits, dt, (A, V, G)),
        ("nodes", nodes, torch.int32, (D, G)),
        ("actions", actions, torch.int32, (D, G)),
        ("length", length, torch.int32, (G,)),
        ("value", value, torch.float32, (G,)),
    ):
        _check(f"backup: {name}", t, want, shape, dev)
    if D > 65535:
        raise ValueError(f"backup: D={D} exceeds the grid's 65535 depths")
    _launch("launch_backup" + STAT_DTYPES[dt], dev, wsum, visits, nodes,
            actions, length, value, A, V, G, D, *backup_geometry(G))
    _count(backup, dt)


# the search's five kernels and the game rules' three (games/kernels.py):
# every wrapper whose launches a run counts
KERNELS = (select_apply_packed, select_apply_packed1, select_apply, select,
           backup) + RULES


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.launches_bf16 = 0


def launch_counts() -> dict:
    """Every wrapper's ``(launches, launches_bf16)``, by name."""
    return {k.__name__: (k.launches, k.launches_bf16) for k in KERNELS}


def set_launch_counts(counts: dict) -> None:
    """Set the counters to ``counts`` (as :func:`launch_counts` gives
    them): after a CUDA graph capture, which called the wrappers but
    launched nothing, the counts from before it."""
    for k in KERNELS:
        k.launches, k.launches_bf16 = counts[k.__name__]


def add_launches(counts: dict) -> None:
    """Add ``counts`` to the counters: a graph replay launches the kernels
    its capture recorded without calling a wrapper."""
    for k in KERNELS:
        n, n16 = counts[k.__name__]
        k.launches += n
        k.launches_bf16 += n16


reset_launch_counts()
