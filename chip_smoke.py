#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``alphatpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --rules   # phases 1-2 and phase 3's rules parity

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions; no CUDA device -> exit 1,
2. build the CUDA kernels from ``alphatpu_torch/csrc`` (nvcc, sm_90a, one
   process per source) and print ptxas's register, stack and spill lines
   (one per instantiation: the packed kernels' carry their column view,
   ``SharedColumns`` or ``DeviceColumns`` - the device placement) and each
   rules kernel instantiation's SASS instructions and branches
   (``cuobjdump``),
3. kernel parity on the card: each of the five search kernels against its plain
   torch version on the same inputs - at the production shape (connect4,
   A=7, V=64, G=8192, D=42, on a tree grown by the port's own search) and
   at a synthetic wide shape (A=169, V=64, G=2048) - with each kernel's
   time at both shapes beside its bound and its plain version's; the
   read-only ``select`` against ``select_apply``'s walk, bit for bit;
   where ``select_apply_packed``'s time goes (``walk_breakdown``); and
   the four walks on a synthetic tree whose parent and action_from columns
   do not fit a block's shared memory (A=7, V=8000, G=512: the device
   placement), timed beside their bounds; then the bf16 instantiations of
   ``select_apply``, ``select`` and ``backup`` (``ALPHATPU_BF16_STATS``)
   against their plain versions, bit for bit and timed, on a connect4 tree
   grown on bf16 planes, on the A=169 tree and (the two walks) in the
   device placement, both rounded to bf16; then the game rules' four
   kernels (``reversi_play``, ``reversi_is_over``, ``line_is_over``,
   ``hex_is_over``) against their plain versions, bit for bit (0 lanes
   that differ), on positions sampled from seeded random games of
   reversi6x6, reversi8x8, tictactoe, connect4, gobang8, gobang9, hex7
   (8192 lanes), gobang13 and hex13 (2048), and reversi8x8 and hex13 at
   their duel halves' 512 and 128 lanes - the pass action, lanes past
   their game's end given any action, full boards; ``reversi_is_over``
   also with the movers without a move gathered first, so that blocks
   skip the opponent's chain - each timed (CUDA events) beside its bound,
   the launch floor (a one-element add, timed the same way) and its plain
   version's wall,
4. the search on the card against the port's CPU path on a small input,
   at each of the three engine levels,
5. a pre-grown search at 8192 lanes: a fresh level-1 search, then a second
   one with ``segment_rollouts=False`` (the f32 engine); then connect4
   trees of 7,300 nodes (the device placement): a 64-rollout search at
   levels 1 and 2 on the card against the CPU path, and a level-1 search
   of 7,300 rollouts (``--rollout 7300``) at 128 lanes on the card alone,
6. the per-phase search (``search.select`` / ``expand`` / ``backup``) at
   8192 lanes, against the f32 engine's ``run_mcts`` on the same uniforms,
7. continuous selfplay on connect4 with the 4x512 net from a fixed seed,
   8192 lanes, 64 rollouts per move - 16 rounds at level 1 (two chained
   calls), 8 under ``ALPHATPU_PACK=2``, 8 under ``ALPHATPU_NO_PACK=1`` -
   each with its launch counts checked,
8. every other game family at level 1 with its reference net (random
   weights from a numpy seed), 64 rollouts per move: tictactoe (6x128) at
   1024 lanes for 12 rounds, gobang9 (6x512), hex7 (8x512), reversi6x6 (4x512) and
   reversi8x8 (8x512) at 8192 lanes for 4 rounds each, gobang13 and hex13
   at 2048 lanes for 2 rounds; env-steps/s per family,
9. the shapes the CLI and the families give the kernels (PATH_SHAPES):
   the CLI's tictactoe selfplay (16 rollouts, 1024 lanes) and duel halves
   (8 rollouts, 64 lanes, no root noise), reversi6x6 (the pass column)
   and hex7 at 512 lanes, gobang9, reversi8x8, gobang8, gobang13 and
   hex13 (the training path's <32,6> walk) at 200 lanes (partial blocks
   and warps);
   each the level-1 search on the card against the CPU path (which
   reads the card net's outputs), and all five kernels against their
   plain versions on a tree grown there; then deep, narrow 13x13 trees
   like a trained net's (DEEP_TREES: the gobang13 net from the seed with
   its policy head scaled by 16, roots after 20 random plies, V=65): the
   card against the CPU path at 200 lanes within 1 lane in 512, and all
   five kernels against their plain versions at 2048 lanes (the record's
   lanes, the <32,6> walk), the largest depth reached at least 12,
10. one generation of the training pipeline at full width
   (``pipeline.run_generation``) for each of GEN_GAMES - connect4 (4x512)
   and hex7 (8x512, 49 actions: the 32-lane walk over two slots, and the
   hex flood) at 8192 games, gobang13 (6x512, 169 actions: the walk over
   six slots) at the reference's 2048, hex13 (8x512, 169 actions) at 2048
   - generation-mode selfplay at 64
   rollouts, one epoch at batch 8192, a 1024-game duel at 32 rollouts,
   Elo, and a checkpoint with the buffer, reloaded and compared with the
   live state bit for bit; launches and graph replays as owed, seconds
   per stage and the phase's wall,
11. the CLI end to end, in process (``alphatpu_torch.cli.main``): two
   tictactoe generations at 1024 games, then a third resumed from the
   checkpoint; then the loss replay
   (``alphatpu_torch.benchmarks.ttt_loss_replay``) of the third
   checkpoint against the perfect player, with its verdict counts,
12. evaluation and play: ``eval_vs_probe`` on connect4 (4x512, 64 games,
   64 rollouts, against a depth-4 ``LineProbe``), ``eval_vs_random`` on
   tictactoe (6x128, 256 games, 64 rollouts) and five moves of the
   interactive engine on connect4 (one game, 128 rollouts a move), each
   captured (its steps replayed from CUDA graphs, as a user calls it) and
   eager from the same generator state - equal bit for bit, both times
   printed, the probe's host seconds apart - with its launches checked;
   kernels 1 and 2 against their plain versions
   on a tree grown at the probe games' positions (G=64) and at the
   engine's (G=1); the G=1 search on the card against the CPU path,
13. data parallel on one card: two ranks share the card over gloo
   (``alphatpu_torch.parallel``) and run one connect4 4x512 generation of
   ``run_generation`` (8192 lanes, 4096 a rank, 12 continuous rounds, one
   epoch at batch 8192, a 256-game duel at 8 rollouts cut to 8 moves, a
   checkpoint with the buffer); each rank's launches checked, rank 0's
   selfplay against a one-process run of its lanes on the same stream (at
   most 2 diverged lanes), the averaged update against a one-process
   emulation (rtol 2e-5), the ranks' parameters equal bit for bit, the
   checkpoint reloaded into the world of two bit for bit; the gradient
   bucket's all_reduce timed, over gloo and in a world of one NCCL rank.
   Two ranks on one card measure no scaling,
14. the net zoo at connect4's reference width (res2, norm, value_only,
   recurrent at 4x512; the conv tower at 64 channels x 4): each a
   64-rollout level-1 search of 8192 lanes (launches 64 and 1) and a
   search on the card against the CPU path at 512 lanes; then 4 rounds of
   continuous selfplay with res2,
15. the bench (``python -m alphatpu_torch.bench``'s ``measure``) on
   connect4 at 8192 lanes, 8 rounds in chained chunks of 4, at levels 1
   and 2, with a bf16 tower, and at level 0 - each a warm-up and three timed
   generations, its launches as owed, no illegal move, the repeats'
   identical work, every lane deciding every round; one JSON line each -
   then the rollout ablation's full and select-only variants at 8192
   lanes, captured and eager (``select`` and ``backup`` launched once a
   rollout as owed),
16. the bf16 stat storage end to end, under ``ALPHATPU_BF16_STATS=1``:
   a connect4 search on bf16 planes on the card against the CPU path (512
   lanes), the per-phase API on bf16 planes against ``run_mcts`` (8192
   lanes, bit for bit), the bench's ``measure`` at 8192 lanes (8 rounds in
   chunks of 4; ``select_apply`` 64 launches a round and ``backup`` 1, the
   packed kernels none, no illegal move), a 512-lane duel half and a short
   ``eval_vs_probe`` on connect4 - every launch of the three kernels on
   bf16 planes,
17. one move round as one program (``alphatpu_torch.graphs``): an eager
   round of connect4 selfplay (4x512, 8192 lanes) under
   ``torch.cuda.set_sync_debug_mode("error")``; 8 continuous rounds
   captured as a CUDA graph against 8 eager rounds at levels 1, 2 and 0
   and on bf16 planes - buffer rows, stats, carry and generator state bit
   for bit, launches as owed under replay, env-steps/s of both, capture
   seconds, graph nodes, graph-pool bytes, peak device memory; the call's
   tail (back-fill, buffer write, next carry, stats) captured too; at
   level 1 a second call of each (the captured one all replays, the first
   call's carry left as it was) and a third captured call under
   ``set_sync_debug_mode("error")``; a 512-lane duel half captured
   against eager, bit for bit; two tictactoe ``selfplay_generation``
   calls (1024 lanes) captured against eager, the second under
   ``set_sync_debug_mode("error")``; the tail's device ms, replayed and
   eager; every ablation variant's move (connect4, 2048 lanes) captured
   against eager: tree planes bit for bit,
18. a JSON line of the kernels (for the four walks also ``ms_device`` and
   ``bound_ms_device``, at the device placement's shape; a row for each
   bf16 instantiation, ``<name>_bf16``; a row for each rules kernel,
   timed at reversi8x8's 8192 lanes or gobang13's or hex13's 2048, with
   its time on every game of phase 3 and the launch floor) after each
   phase's wall, then the result line ``{"ok": true, "device": {...}}``.

``--rules`` runs phases 1-2 and phase 3's rules parity alone and ends
with the rules' JSON line (no result line): the rules kernels of another
tree of the port, timed by this script (copy it to that tree's root).

Launch counts: before each path every count is set to 0, and after it the
counts must be exactly what the path owes (launches made for the parity
checks are not counted; a replayed CUDA graph counts the launches its
capture recorded, so captured rounds owe what eager ones owe): a search
of R rollouts owes R launches of its engine's walk and one ``backup``,
so ``eval_vs_probe`` owes plies x 64 and plies, ``eval_vs_random`` 2 x 9
x 64 and 2 x 9, the interactive engine 128 and 1 a move.  The rules
kernels count too: each rollout plays the leaf's move and tests its end
once, and each move of selfplay, a duel, an evaluation or the probe once
more, so a round of R rollouts owes R + 1 of the game's ``is_over``
kernel (``line_is_over`` on the line games, ``hex_is_over`` on hex) and,
on reversi, R + 1 ``reversi_play`` (the line games and hex play with
torch ops).  The kernels line reports, for ``select_apply_packed`` and
``backup``, the launches of the CLI run (the main path, phase 11); for
the other three kernels those of the path that runs each (phases 6 and
7); for the bf16 instantiations those of phase 16's bench generation and
(``select``) its per-phase search; for the rules kernels those of the
CLI (``line_is_over``) and of phase 8's reversi8x8 and hex13 selfplay.

Kernel parity: each walk kernel and its plain version sum in the same
order and round each operation alike, so the stat planes after the apply
phase, the paths, leaves, needs_alloc and the root policy must be equal
bit for bit; the backup's visits exactly and its wsum to rtol 1e-6.
Phase 3 times each kernel at both of its shapes (CUDA events, 20 launches
back to back on fresh planes) beside its bound on the timed call's own
inputs (``alphatpu_torch.mcts.bounds``: bytes over 3.35 TB/s, operations
over 67 TFLOP/s, whichever is larger), its plain version's wall time and,
for backup, the device time of two ``index_put_(accumulate=True)`` calls
that compute the same adds (a yardstick the port never calls).
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from functools import partial

SEED = 0
CPUCT = 1.5
LANES = 8192
ROLLOUTS = 64
CHUNK_ROUNDS = 8
CHUNKS = 2  # 16 rounds at level 1
WIDE = (169, 64, 2048)  # A, V, G of the synthetic wide shape
# A, V, G of a synthetic tree whose columns do not fit a block
DEVICE_SHAPE = (7, 8000, 512)
# tree nodes of the connect4 searches in the device placement (from
# 7,249), and the lanes of the one with as many rollouts
BIG_TREE, BIG_TREE_G = 7300, 128
SMALL_G = 512  # lanes of the card-vs-CPU searches
GEN_DUEL = (1024, 32)  # games, rollouts of the pipeline generation's duel
# phase 10's generations in order, (game, games): gobang13 at the
# reference's 2048 lanes (A=169: the 32-lane walk over six slots)
GEN_GAMES = (("connect4", LANES), ("hex7", LANES), ("gobang13", 2048),
             ("hex13", 2048))
CLI_GAMES, CLI_DUEL_GAMES = 1024, 128
CLI_ROLLOUTS, CLI_DUEL_ROLLOUTS = 16, 8
L2_ROLLOUTS = 64  # the CLI's level-2 generation: the records' rollouts
# phase 12: probe games and the probe's depth; the interactive engine's
# moves and rollouts a move (the CLI's --readout default)
PROBE_GAMES, PROBE_DEPTH = 64, 4
PLAY_MOVES, PLAY_READOUT = 5, 128
DUEL_CPUCT = 2.0  # DuelConfig's
# phase 13: ranks sharing the card, continuous rounds of their generation,
# its duel (games, rollouts, move bound), all_reduce repetitions timed and
# the seconds the ranks may take
DP_RANKS, DP_ROUNDS = 2, 12
DP_DUEL = (256, 8, 8)
DP_ALLREDUCE_REPS = 5
DP_TIMEOUT = 600
# phase 14: the zoo nets, and the rounds of res2's continuous selfplay
ZOO_NETS = ("res2", "norm", "conv", "value_only", "recurrent")
ZOO_ROUNDS = 4
# phase 15: the bench's cut rounds and chunk, its runs (measure's keyword
# arguments), and the ablation's variants
BENCH_ROUNDS, BENCH_CHUNK = 8, 4
BENCH_RUNS = ({"pack_level": 1}, {"pack_level": 2}, {"bf16": True},
              {"pack_level": 0})
# phase 11: the loss replay's sampling plies (the probe protocol's)
REPLAY_TEMP_MOVES = 8
# phase 16: the duel half (games, rollouts, move bound) and the
# eval_vs_probe (games, probe depth) under ALPHATPU_BF16_STATS
BF16_DUEL = (512, 32, 12)
BF16_PROBE = (16, 2)
# phase 17: continuous rounds of each captured-vs-eager run, and the duel
# half (games, rollouts) held to its eager rounds
CAPTURE_ROUNDS = 8
CAPTURE_DUEL = (512, 32)
# and the lanes of its generation-mode calls (tictactoe) and of its
# ablation moves (connect4)
CAPTURE_GENERATION, CAPTURE_ABLATE = 1024, 2048
# phase 17's runs: label, engine switches, the walk kernel they launch
CAPTURE_RUNS = (
    ("level 1", {}, "select_apply_packed"),
    ("level 2", {"ALPHATPU_PACK": "2"}, "select_apply_packed1"),
    ("level 0", {"ALPHATPU_NO_PACK": "1"}, "select_apply"),
    ("bf16 planes", {"ALPHATPU_BF16_STATS": "1"}, "select_apply"),
)
SWITCHES = ("ALPHATPU_PACK", "ALPHATPU_NO_PACK", "ALPHATPU_BF16_STATS")
ABLATE_VARIANTS = ("full", "select-only")
# (game, rollouts = tree nodes, lanes, cpuct, training) of phase 9
PATH_SHAPES = (
    ("tictactoe", CLI_ROLLOUTS, CLI_GAMES, CPUCT, True),
    ("tictactoe", CLI_DUEL_ROLLOUTS, CLI_DUEL_GAMES // 2, DUEL_CPUCT, False),
    ("reversi6x6", ROLLOUTS, SMALL_G, CPUCT, True),
    ("hex7", ROLLOUTS, SMALL_G, CPUCT, True),
    ("gobang9", ROLLOUTS, 200, CPUCT, True),
    ("reversi8x8", ROLLOUTS, 200, CPUCT, True),
    ("gobang8", ROLLOUTS, 200, CPUCT, True),
    ("gobang13", ROLLOUTS, 200, CPUCT, True),
    ("hex13", ROLLOUTS, 200, CPUCT, True),
)
# phase 9's deep, narrow trees: game, nodes (64 rollouts), lanes of the
# kernel parity, lanes of the card-vs-CPU search, the policy head's scale,
# random plies before the roots, the least largest depth to reach
DEEP_TREES = ("gobang13", 65, 2048, 200, 16.0, 20, 12)
# game -> (lanes, rounds) of its continuous selfplay at full width
FAMILIES = {
    "tictactoe": (1024, 12),
    "gobang9": (8192, 4),
    "hex7": (8192, 4),
    "reversi6x6": (8192, 4),
    "reversi8x8": (8192, 4),
    "gobang13": (2048, 2),
    "hex13": (2048, 2),
}
WALKS = ("select_apply_packed", "select_apply_packed1", "select_apply",
         "select")
CSRC = "alphatpu_torch/csrc/"
PALLAS = "alphatpu/mcts/pallas_kernels.py:"
# name -> (source, the TPU kernel it replaces): the search kernels
KERNELS = {
    "select_apply_packed": ("select_apply_packed.cu", "1008"),
    "select_apply_packed1": ("select_apply_packed1.cu", "1259"),
    "select_apply": ("select_apply.cu", "707"),
    "select": ("select.cu", "640"),
    "backup": ("backup.cu", "1349"),
}
# the rules kernels (games/kernels.py, csrc/rules.cu), each replacing no
# Pallas kernel: name -> the reference rule whose XLA fusion it stands for
RULES = {
    "reversi_play": "alphatpu/games/reversi.py:124",
    "reversi_is_over": "alphatpu/games/reversi.py:144",
    "line_is_over": "alphatpu/games/gobang.py:65",
    "hex_is_over": "alphatpu/games/hex.py:95",
}
# every wrapper whose launches a path owes
COUNTED = (*KERNELS, *RULES)
# phase 3's rules parity: (game, lanes), timed at the shape each record's
# training path gives the kernels, and at the duel halves' lanes (a
# sixteenth) of reversi8x8, connect4, gobang13 and hex13; reversi's two are
# reported at reversi8x8's 8192 lanes, line_is_over at gobang13's 2048,
# hex_is_over at hex13's 2048
RULES_GAMES = (("reversi6x6", LANES), ("reversi8x8", LANES),
               ("tictactoe", LANES), ("connect4", LANES),
               ("gobang8", LANES), ("gobang9", LANES), ("gobang13", 2048),
               ("hex7", LANES), ("hex13", 2048), ("reversi8x8", LANES // 16),
               ("connect4", LANES // 16), ("gobang13", 2048 // 16),
               ("hex13", 2048 // 16))
RULES_REPORTED = {"reversi_play": ("reversi8x8", LANES),
                  "reversi_is_over": ("reversi8x8", LANES),
                  "line_is_over": ("gobang13", 2048),
                  "hex_is_over": ("hex13", 2048)}
# the kernels with a bf16 instantiation (ALPHATPU_BF16_STATS): its row in
# the kernels line is the name + "_bf16"
BF16_KERNELS = ("select_apply", "select", "backup")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def tie_limit(G: int) -> int:
    return max(2, G // 500)


def diverged_lanes(a, b):
    """bool[G]: lanes where any of the paired tensors differ."""
    import torch

    bad = torch.zeros(a[0].shape[-1], dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        bad |= (x != y).reshape(-1, x.shape[-1]).any(0)
    return bad


def launch_counts(K) -> dict:
    counts = K.launch_counts()
    return {name: counts[name][0] for name in COUNTED}


def rules(game, calls: int) -> dict:
    """The rules launches of ``calls`` calls of ``game.play`` and as many
    of ``game.is_over`` on the card (``games.kernels.rules_owed``)."""
    from alphatpu_torch.games.kernels import rules_owed

    return rules_owed(game, calls)


def expect_launches(K, what: str, owed: dict) -> dict:
    """The counts since the last reset, which must equal ``owed`` (kernels
    not named there owe 0)."""
    got = launch_counts(K)
    want = {name: owed.get(name, 0) for name in COUNTED}
    print(f"launches in {what}: {got}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, owed {want}")
    return got


def compare_walk(name, kernel, plain, planes):
    """One walk kernel call and one plain call, each on its own copy of
    the mutable ``planes``.  The planes and every output must come out
    equal bit for bit; returns (n diverged lanes (0), root_pi max abs error
    (0), kernel Selection)."""
    import torch

    ka = [t.clone() for t in planes]
    pa = [t.clone() for t in planes]
    sk = kernel(*ka)
    sp = plain(*pa)
    torch.cuda.synchronize()
    for x, y in zip(ka, pa):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: the updated planes differ")
    bad = diverged_lanes(
        (sk.nodes, sk.actions, sk.leaf, sk.leaf_action, sk.needs_alloc),
        (sp.nodes, sp.actions, sp.leaf, sp.leaf_action, sp.needs_alloc))
    n = int(bad.sum())
    err = float((sk.root_pi - sp.root_pi).abs().max())
    if n or not torch.equal(sk.root_pi, sp.root_pi):
        raise AssertionError(f"{name}: {n} diverged lanes, root_pi max abs "
                             f"err {err}")
    return n, err, sk


def pending_from(K, sel, next_idx, A, scale, gen):
    """A realistic pending update: the walk of ``sel``, a random leaf value
    (on the 1/scale grid unless ``scale`` is None), a random normalized
    prior row at the leaf."""
    import torch

    G = sel.leaf.shape[0]
    dev = sel.leaf.device
    newp = torch.rand((A, G), generator=gen, device=dev)
    value = torch.rand((G,), generator=gen, device=dev)
    return K.PendingUpdate(
        nodes=sel.nodes, actions=sel.actions,
        length=(sel.nodes >= 0).sum(0, dtype=torch.int32),
        value=value if scale is None else K.quantize_value(value, scale),
        leaf=torch.where(sel.needs_alloc, next_idx, sel.leaf),
        newp=newp / newp.sum(0, keepdim=True),
        write=torch.ones((G,), dtype=torch.bool, device=dev))


def device_ms(fn, reps):
    """Device time per call of ``fn(i)``: the calls are queued behind a
    sleeping kernel so they run back to back, then timed by CUDA events."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps):
    """Wall time per call of ``fn(i)`` (for the plain versions, whose
    early-exit tests synchronise with the host anyway)."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def synthetic_tree(A, V, G, scale, seed):
    """A random tree of V-2 allocated nodes per game: children under
    distinct (parent, action) edges, normalized priors over random legal
    moves, small integer visits on the child edges, value sums on the
    1/scale grid.  Node v < A hangs under a random earlier node by the
    v-th action of a per-game permutation; node v >= A (a tree larger than
    the row) under a random earlier node with a free action - the first
    free one from a random start - or, if it has none, under node v - 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = V - 2
    gi = np.arange(G)
    parent = np.full((V, G), -1, np.int32)
    action_from = np.zeros((V, G), np.int32)
    perm = np.argsort(rng.random((A, G)), axis=0).astype(np.int32)
    expanded = np.zeros((V, G), bool)
    expanded[:n] = rng.random((n, G)) < 0.9
    expanded[0] = True
    legal = rng.random((A, V, G)) < 0.7
    # as in a grown tree, only edges with a child have visits, and they
    # hold most of their node's mass (so that walks go deep)
    child = np.zeros((A, V, G), bool)
    turn = np.arange(A)[:, None]
    for v in range(1, n):
        up = rng.integers(0, v, G)
        if v < A:
            action = perm[v]
        else:
            up = np.where(child[:, up, gi].all(0), v - 1, up)
            order = (rng.integers(0, A, G) + turn) % A  # [A, G]
            free = ~child[order, up, gi]
            action = order[free.argmax(0), gi]
        parent[v] = up
        action_from[v] = action
        expanded[up, gi] = True
        legal[action, up, gi] = True
        child[action, up, gi] = True
    legal &= expanded[None]
    prior = np.where(legal, rng.random((A, V, G)), 0.0)
    prior = np.where(child, prior + 20.0, prior)
    prior = (prior / np.maximum(prior.sum(0, keepdims=True), 1e-30))
    visits = np.where(child, rng.integers(1, 5, (A, V, G)), 0)
    wsum = np.floor(rng.random((A, V, G)) * visits * scale) / scale
    return (prior.astype(np.float32), wsum.astype(np.float32),
            visits.astype(np.float32), parent, action_from, expanded,
            np.full((G,), n, np.int32))


def synthetic_tree_on(dev, A, V, G, scale, seed):
    """:func:`synthetic_tree` as a ``Tree`` on ``dev`` (no game states)."""
    import torch

    from alphatpu_torch.mcts.tree import Tree

    prior, wsum, visits, parent, action_from, expanded, next_idx = (
        torch.from_numpy(x).to(dev)
        for x in synthetic_tree(A, V, G, scale, seed))
    return Tree(parent=parent, action_from=action_from, expanded=expanded,
                states=None, prior=prior, wsum=wsum, visits=visits,
                next_idx=next_idx)


def as_bf16(tree):
    """``tree`` with its stat planes rounded to bf16 (the rest shared)."""
    import dataclasses

    import torch

    return dataclasses.replace(
        tree, **{f: getattr(tree, f).to(torch.bfloat16)
                 for f in ("prior", "wsum", "visits")})


def backup_yardstick(wsum, visits, nodes, actions, length, value):
    """The backup as two ``index_put_(accumulate=True)`` calls on flat
    indices: returns ``fn(wsum, visits)`` that adds in place, with the
    indices and contributions built here, outside any timed region.  A
    yardstick only: the port never calls it."""
    import torch

    A, V, G = wsum.shape
    d, g = (nodes >= 0).nonzero(as_tuple=True)
    flat = (actions[d, g].long() * V + nodes[d, g].long()) * G + g
    k = length[g] - 1 - d
    # on bf16 planes index_put_ adds bf16 values: the contribution is
    # rounded before the add, the kernel rounds once after it
    contrib = torch.where(k % 2 == 0, 1.0 - value[g], value[g]).to(
        wsum.dtype)
    ones = torch.ones_like(contrib)

    def fn(w, n):
        w.view(-1).index_put_((flat,), contrib, accumulate=True)
        n.view(-1).index_put_((flat,), ones, accumulate=True)
    return fn


def show_timing(r) -> str:
    """The timing part of a parity line: kernel, bound, plain, library."""
    c = r["cost"]
    lib = r["library_ms"]
    return (f"; kernel {r['ms']:.4f} ms, {c.bound_ms / r['ms']:.1%} of its "
            f"bound {c.bound_ms:.6f} ms ({c.nbytes} B, {c.ops} ops, bound by "
            f"{c.bound_by}); plain {r['plain_ms']:.2f} ms"
            + (f"; library {lib:.4f} ms" if lib is not None else ""))


def parity(K, tree, D, gen, cpuct, scale, label, timed, kernels=KERNELS):
    """Kernel parity of the four walk kernels and backup on one tree (and
    a level-1 ``scale``, ``D`` depths), or of those named in ``kernels``:
    each kernel against its plain version with an
    empty and with a real pending update, and select against
    select_apply's walk bit for bit.  On a tree of bf16 stat planes the
    three-plane kernels (``BF16_KERNELS``) run their bf16 instantiations.
    With ``timed``, each kernel's device
    time, its bound on this call's inputs (``alphatpu_torch.mcts.bounds``),
    its plain version's wall time and, for backup, the library yardstick's
    device time.  Returns {name: {"err", "ms", "plain_ms", "cost",
    "library_ms"}}."""
    import torch

    from alphatpu_torch.mcts.bounds import backup_cost, walk_cost

    prior, wsum, visits = tree.prior, tree.wsum, tree.visits
    itemsize = prior.element_size()
    A, V, G = prior.shape
    dev = prior.device
    walk = (tree.parent, tree.action_from, tree.expanded)
    layout = K.packed1_layout(V)
    empty = K.empty_pending(D, A, G, dev)
    probs = [torch.rand((D, G), generator=gen, device=dev) for _ in range(2)]

    # each walk kernel: (planes, kernel(*planes, p, pend), plain, value
    # grid of its pending update); the planes are built for those asked for
    engines = {
        "select_apply_packed": (
            lambda: (prior, K.pack_stats(wsum, visits, scale)),
            lambda pr, pk, p, pend: K.select_apply_packed(
                pr, pk, *walk, p, pend, cpuct, scale),
            lambda pr, pk, p, pend: K.select_apply_packed_plain(
                pr, pk, *walk, p, pend, cpuct, scale), scale),
        "select_apply_packed1": (
            lambda: (K.pack1_stats(prior, wsum, visits, layout),),
            lambda pk, p, pend: K.select_apply_packed1(
                pk, *walk, p, pend, cpuct, layout),
            lambda pk, p, pend: K.select_apply_packed1_plain(
                pk, *walk, p, pend, cpuct, layout), layout.scale),
        "select_apply": (
            lambda: (prior, wsum, visits),
            lambda pr, w, n, p, pend: K.select_apply(
                pr, w, n, *walk, p, pend, cpuct),
            lambda pr, w, n, p, pend: K.select_apply_plain(
                pr, w, n, *walk, p, pend, cpuct), None),
    }
    out = {}
    for name, (make_planes, kern, plain, grid) in engines.items():
        if name not in kernels:
            continue
        planes = make_planes()
        n1, e1, sel = compare_walk(
            name, lambda *x: kern(*x, probs[0], empty),
            lambda *x: plain(*x, probs[0], empty), planes)
        pend = pending_from(K, sel, tree.next_idx, A, grid, gen)
        n2, e2, sel2 = compare_walk(
            name, lambda *x: kern(*x, probs[1], pend),
            lambda *x: plain(*x, probs[1], pend), planes)
        depth = float((sel.nodes >= 0).sum(0).float().mean())
        longest = int((sel2.nodes >= 0).sum(0).max())  # of the timed walk
        r = out[name] = {"err": max(e1, e2), "ms": None, "plain_ms": None,
                         "cost": walk_cost(name, V, sel2, pend,
                                           itemsize=planes[0].element_size()),
                         "library_ms": None}
        if timed:
            reps = 20
            copies = [[t.clone() for t in planes] for _ in range(reps + 1)]
            r["ms"] = device_ms(lambda i: kern(*copies[i], probs[1], pend),
                                reps)
            copies = [[t.clone() for t in planes] for _ in range(4)]
            r["plain_ms"] = wall_ms(
                lambda i: plain(*copies[i], probs[1], pend), 3)
            del copies
        print(f"{name} parity, {label}: diverged lanes {n1}/{G} and {n2}/{G},"
              f" root_pi max abs err {max(e1, e2):.3g}, mean path length "
              f"{depth:.2f}, longest {longest}"
              + (show_timing(r) if timed else ""))

    # select: the read-only walk, against its plain version and against
    # select_apply's walk on the same planes with an empty pending update
    if "select" in kernels:
        name = "select"
        errs, ns = [], []
        for p in probs:
            n, e, sk = compare_walk(
                name, lambda *x: K.select(*x, *walk, p, cpuct),
                lambda *x: K.select_plain(*x, *walk, p, cpuct),
                (prior, wsum, visits))
            errs.append(e)
            ns.append(n)
            s4 = K.select_apply(prior.clone(), wsum.clone(), visits.clone(),
                                *walk, p, empty, cpuct)
            if not all(torch.equal(x, y) for x, y in zip(sk, s4)):
                raise AssertionError("select differs from select_apply's walk")
        r = out[name] = {"err": max(errs), "ms": None, "plain_ms": None,
                         "cost": walk_cost(name, V, sk, itemsize=itemsize),
                         "library_ms": None}
        if timed:
            # a copy of the planes per launch, as for the other kernels: the
            # three planes fit the 50 MB L2, and a search finds them cold
            reps = 20
            copies = [[t.clone() for t in (prior, wsum, visits)]
                      for _ in range(reps + 1)]
            r["ms"] = device_ms(lambda i: K.select(*copies[i], *walk, probs[1],
                                                   cpuct), reps)
            r["plain_ms"] = wall_ms(lambda i: K.select_plain(
                *copies[i], *walk, probs[1], cpuct), 3)
            del copies
        print(f"select parity, {label}: diverged lanes {ns[0]}/{G} and "
              f"{ns[1]}/{G}, root_pi max abs "
              f"err {max(errs):.3g}; equal to select_apply's walk bit for "
              f"bit; longest path {int((sk.nodes >= 0).sum(0).max())}"
              + (show_timing(r) if timed else ""))

    if "backup" not in kernels:
        return out

    # backup: the flush of a pending update onto the stats (the path of
    # the last engine's walk above)
    name = "backup"
    value = torch.rand((G,), generator=gen, device=dev)
    path = (sel.nodes, sel.actions, pend.length, value)
    bk = (wsum.clone(), visits.clone())
    bp = (wsum.clone(), visits.clone())
    K.backup(*bk, *path)
    K.backup_plain(*bp, *path)
    torch.cuda.synchronize()
    if not torch.equal(bk[1], bp[1]):
        raise AssertionError("backup: visits differ")
    if itemsize == 2 and not torch.equal(bk[0], bp[0]):
        raise AssertionError("backup: bf16 wsum differs")
    torch.testing.assert_close(bk[0], bp[0], rtol=1e-6, atol=0.0)
    err = float(max((bk[0] - bp[0]).abs().max(), (bk[1] - bp[1]).abs().max()))
    r = out[name] = {"err": err, "ms": None, "plain_ms": None,
                     "cost": backup_cost(sel.nodes, itemsize),
                     "library_ms": None}
    if timed:
        reps = 20
        copies = [(wsum.clone(), visits.clone()) for _ in range(reps + 1)]
        r["ms"] = device_ms(lambda i: K.backup(*copies[i], *path), reps)
        library = backup_yardstick(wsum, visits, *path)
        copies = [(wsum.clone(), visits.clone()) for _ in range(reps + 1)]
        r["library_ms"] = device_ms(lambda i: library(*copies[i]), reps)
        # copies[1] took one call (device_ms runs fn(0) twice); on bf16
        # planes its double rounding may put wsum one bf16 step away
        lib_w, lib_n = copies[1]
        step = (lib_w.float() - bk[0].float()).abs() <= (
            bk[0].float().abs() * 2.0 ** -7 if itemsize == 2 else 0.0)
        if not (bool(step.all()) and torch.equal(lib_n, bk[1])):
            raise AssertionError("backup: the index_put_ yardstick differs")
        copies = [(wsum.clone(), visits.clone()) for _ in range(4)]
        r["plain_ms"] = wall_ms(lambda i: K.backup_plain(*copies[i], *path),
                                3)
        del copies
    print(f"backup parity, {label}: max abs err {err:.3g}"
          + (show_timing(r) if timed else ""))
    return out


def walk_breakdown(K, tree, D, gen, scale, card):
    """Where ``select_apply_packed``'s time goes on a grown tree, timed like
    phase 3 (an empty pending update): the launch floor (a one-element
    add), the kernel as it is, with every visit count zeroed (no Newton
    solve; the walks change), with the root's flag cleared (the apply
    phase and the root's row and policy only), and on the first 256
    games alone (the same chains, 1/32 of the games).  Flat in the games
    means a latency chain, not throughput, sets the time."""
    import torch

    dev = tree.prior.device
    G = tree.prior.shape[2]
    probs = torch.rand((D, G), generator=gen, device=dev)
    packed = K.pack_stats(tree.wsum, tree.visits, scale)
    walk = (tree.parent, tree.action_from, tree.expanded)
    rootless = tree.expanded.clone()
    rootless[0] = False

    def timed(planes, walk, probs, reps=20):
        A, _, g = planes[0].shape
        empty = K.empty_pending(D, A, g, dev)
        copies = [[t.clone() for t in planes] for _ in range(reps + 1)]
        return device_ms(lambda i: K.select_apply_packed(
            *copies[i], *walk, probs, empty, CPUCT, scale), reps)

    one = torch.zeros(1, device=dev)
    cut = 256
    part = [x[..., :cut].contiguous() for x in (tree.prior, packed, *walk,
                                                probs)]
    times = {
        "launch floor": device_ms(lambda i: one.add_(1.0), 20),
        "as is": timed((tree.prior, packed), walk, probs),
        "no visits": timed((tree.prior, torch.zeros_like(packed)), walk,
                           probs),
        "root only": timed((tree.prior, packed),
                           (tree.parent, tree.action_from, rootless), probs),
        f"first {cut} games": timed(part[:2], part[2:5], part[5]),
    }
    print("select_apply_packed breakdown, connect4: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()) + f"  [{card}]")


def rules_parity(dev, card: str) -> dict:
    """Phase 3's rules kernels: for each (game, lanes) of RULES_GAMES,
    positions and actions sampled from seeded random games
    (``games.kernels.sample_positions``: lanes past their game's end
    given any action, reversi's pass, full boards), and each kernel the
    game launches against its plain version on the same tensors - every
    output, lane by lane; reversi's move with 64- and 32-bit actions, and
    the end test after the move too (reversi's also on the positions
    reordered by ``games.kernels.stuck_first``).  Each kernel is timed
    (CUDA events, back to back) beside its bound
    (``mcts.bounds.rules_cost``), the launch floor (a one-element in-place
    add on the card, timed alike: what any launch costs) and its plain
    version's wall.  Returns {kernel: result} at RULES_REPORTED's shape,
    each result with its time on every (game, lanes) and the floor."""
    import torch

    from alphatpu_torch.games import kernels as R
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.bounds import rules_cost

    t_phase = time.perf_counter()
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda i: one.add_(1.0), 50)
    print(f"rules parity: launch floor {floor:.4f} ms (a one-element add_, "
          f"50 launches back to back)  [{card}]")
    out = {}
    for name, G in RULES_GAMES:
        game = make_game(name)
        spec = game.spec
        pos, action = R.sample_positions(game, G, SEED + 51, dev)
        if game.play_kernel:
            played = type(pos)(*R.reversi_play_plain(
                spec, pos.bplayer, pos.bopponent, pos.player, action))
            calls = {
                "reversi_play": (
                    lambda p, a: R.reversi_play(spec, p.bplayer,
                                                p.bopponent, p.player, a),
                    lambda p, a: R.reversi_play_plain(
                        spec, p.bplayer, p.bopponent, p.player, a),
                    [(pos, action), (pos, action.int())]),
                "reversi_is_over": (
                    lambda p, a: R.reversi_is_over(spec, *p),
                    lambda p, a: R.reversi_is_over_plain(spec, *p),
                    [(pos, None), (played, None),
                     (R.stuck_first(pos), None)]),
            }
        elif game.is_over_kernel == "hex_is_over":
            n = game.n
            played = game.play(pos, action)  # torch ops on hex
            calls = {"hex_is_over": (
                lambda p, a: R.hex_is_over(spec, n, p.bopponent, p.player),
                lambda p, a: R.hex_is_over_plain(spec, n, p.bopponent,
                                                 p.player),
                [(pos, None), (played, None)])}
        else:
            nvict = game.nvict
            played = game.play(pos, action)  # torch ops on a line game
            calls = {"line_is_over": (
                lambda p, a: R.line_is_over(spec, nvict, p.bplayer,
                                            p.bopponent, p.player),
                lambda p, a: R.line_is_over_plain(spec, nvict, p.bplayer,
                                                  p.bopponent, p.player),
                [(pos, None), (played, None)])}
        done = game.is_over(pos)[0]
        full = bb_full(game, pos)
        passing = int((action == game.max_actions - 1).sum()) \
            if game.play_kernel else 0
        for kernel, (fast, plain, inputs) in calls.items():
            bad = torch.zeros((G,), dtype=torch.bool, device=dev)
            err = 0.0
            for p, a in inputs:
                for x, y in zip(fast(p, a), plain(p, a)):
                    if x.dtype != y.dtype or x.shape != y.shape:
                        raise AssertionError(f"{kernel} on {name}: "
                                             f"{x.dtype}{tuple(x.shape)} "
                                             f"!= {y.dtype}{tuple(y.shape)}")
                    bad |= (x != y).reshape(G, -1).any(1)
                    err = max(err, float((x.long() - y.long()).abs().max()))
            torch.cuda.synchronize()
            p, a = inputs[0]
            ms = device_ms(lambda i: fast(p, a), 50)
            plain_ms = wall_ms(lambda i: plain(p, a), 3)
            cost = rules_cost(kernel, spec, G, action.element_size(),
                              getattr(game, "nvict", 0))
            print(f"rules parity: {kernel} on {name}, {G} lanes ("
                  f"{int(done.sum())} games over, {int(full.sum())} full "
                  f"boards" + (f", {passing} passes" if passing else "")
                  + f"): lanes that differ {int(bad.sum())}/{G}, max abs "
                  f"err {err}; {ms:.4f} ms a launch, {ms - floor:.4f} ms "
                  f"over the floor, bound {cost.bound_ms:.6f} ms ("
                  f"{cost.bound_by}, {cost.nbytes} B; share "
                  f"{cost.bound_ms / ms:.1%}), plain {plain_ms:.3f} ms  "
                  f"[{card}]")
            if int(bad.sum()) or err:
                raise AssertionError(f"{kernel} on {name}: {int(bad.sum())} "
                                     "lanes differ from the plain version")
            r = out.setdefault(kernel, {"ms_by_game": {},
                                        "plain_ms_by_game": {}, "err": 0.0,
                                        "launch_floor_ms": floor})
            r["ms_by_game"][f"{name} G={G}"] = ms
            r["plain_ms_by_game"][f"{name} G={G}"] = plain_ms
            r["err"] = max(r["err"], err)
            if RULES_REPORTED[kernel] == (name, G):
                r.update(ms=ms, plain_ms=plain_ms, cost=cost,
                         shape=f"{name} G={G}")
    print(f"rules parity: {time.perf_counter() - t_phase:.3f} s  [{card}]")
    return out


def bb_full(game, pos):
    """bool[G]: every cell of the board holds a stone."""
    from alphatpu_torch import bitboard as bb

    return bb.popcount(game.spec, pos.bplayer | pos.bopponent) == \
        game.spec.nbits


def search_vs_cpu(game, net, net_cpu, dev, V, G, level, cpuct=CPUCT,
                  training=True, rollouts=None, stat_dtype=None,
                  positions=None, limit=None):
    """``run_mcts`` at one engine level on the card and on the CPU, from
    the same uniforms, ``rollouts`` of them (default V) on trees of V
    nodes rooted at ``positions`` (CPU tensors; default the initial
    position), at most ``limit`` lanes diverged (default ``tie_limit``).
    Exact: the tree structure, visits and (packed levels) wsum; the
    level-2 prior to one step of its 1/2048 grid, other floats to rtol
    1e-4 (the net's matmuls round differently on the two
    devices, and a leaf value or prior that lands on the other side of a
    grid point changes a lane; those lanes count as diverged).  On bf16
    stat planes (``stat_dtype``; level 0 whatever ``level`` says) a stored
    value rounds once more, so prior, wsum and the root policy may lie one
    bf16 step (2^-7 relative) apart."""
    import torch

    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree

    cpu = torch.device("cpu")
    R = V if rollouts is None else rollouts
    D = min(game.max_game_length, V)
    probs = torch.rand((R, D, G), generator=torch.Generator().manual_seed(1))
    dtype = stat_dtype or torch.float32
    searched = []
    root = game.initial(G) if positions is None else positions
    for d, n in ((dev, net), (cpu, net_cpu)):
        t = init_tree(game, type(root)(*(x.to(d) for x in root)), V,
                      stat_dtype=dtype)
        _, pi = run_mcts(game, n, t, rollouts=R, cpuct=cpuct,
                         training=training, probs=probs.to(d),
                         packed_stats=level)
        if {x.dtype for x in (t.prior, t.wsum, t.visits)} != {dtype}:
            raise AssertionError(f"search: stat planes not {dtype}")
        searched.append((t, pi))
    (tg, pig), (tc, pic) = searched
    fields = ["parent", "action_from", "expanded", "next_idx", "visits"]
    if level:
        fields.append("wsum")
    bad = diverged_lanes(tuple(getattr(tg, f).cpu() for f in fields),
                         tuple(getattr(tc, f) for f in fields))
    n_bad = int(bad.sum())
    if n_bad > (tie_limit(G) if limit is None else limit):
        raise AssertionError(f"search card vs CPU, level {level}: {n_bad} "
                             "diverged lanes")
    ok = ~bad
    grid = 1.0 / 2048 if level == 2 else 0.0
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(tg.prior.cpu()[..., ok], tc.prior[..., ok],
                               rtol=rtol, atol=1e-6 + grid)
    torch.testing.assert_close(tg.wsum.cpu()[..., ok], tc.wsum[..., ok],
                               rtol=rtol, atol=1e-5)
    torch.testing.assert_close(pig.cpu()[:, ok], pic[:, ok], rtol=rtol,
                               atol=1e-6 + grid)
    print(f"search on the card vs the CPU path, {game.name}, level {level} "
          f"(G={G}, R={R}, V={V}, cpuct {cpuct}, training={training}"
          + (", bf16 stat planes" if dtype == torch.bfloat16 else "")
          + (", deep trees" if positions is not None else "")
          + f"): diverged lanes {n_bad}/{G}")


def big_tree_searches(K, game, net, net_cpu, dev, card) -> None:
    """Phase 5's connect4 trees of BIG_TREE nodes, whose columns exceed a
    block's shared memory: the packed kernels take the device placement.
    A 64-rollout search at levels 1 and 2 on the card against the CPU path
    (launches as owed), then a level-1 search of as many rollouts as nodes
    on BIG_TREE_G lanes, on the card alone: every rollout but the first
    backs up through a root edge."""
    import torch

    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree

    A, V = game.max_actions, BIG_TREE
    for G in (SMALL_G, BIG_TREE_G):
        geo = K.walk_geometry(A, G, V)
        if geo.placement != K.DEVICE_COLUMNS:
            raise AssertionError(f"A={A} V={V} G={G}: geometry {geo}")
    for level, kernel in ((1, "select_apply_packed"),
                          (2, "select_apply_packed1")):
        K.reset_launch_counts()
        search_vs_cpu(game, net, net_cpu, dev, V, SMALL_G, level,
                      rollouts=ROLLOUTS)
        expect_launches(K, f"the level-{level} search of a {V}-node tree",
                        {kernel: ROLLOUTS, "backup": 1,
                         **rules(game, ROLLOUTS)})

    G = BIG_TREE_G
    tree = init_tree(game, game.initial(G, dev), V)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    run_mcts(game, net, tree, rollouts=V, cpuct=CPUCT, training=True,
             generator=torch.Generator(device=dev).manual_seed(SEED + 3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_launches(K, f"the {V}-rollout level-1 search",
                    {"select_apply_packed": V, "backup": 1, **rules(game, V)})
    root = tree.visits[:, 0, :].sum(0)
    if not bool((root == V - 1).all()):
        raise AssertionError(f"{V}-rollout search: root visits "
                             f"{root.unique().tolist()} != {V - 1}")
    if not bool(torch.isfinite(tree.wsum).all()):
        raise AssertionError(f"{V}-rollout search: non-finite wsum")
    print(f"level-1 search of {V} rollouts on {V}-node trees (--rollout "
          f"{V}), connect4, {G} lanes: {wall:.3f} s, root visits {V - 1} "
          f"in every game, mean nodes allocated "
          f"{float(tree.next_idx.float().mean()):.2f}  [{card}]")


def phase_search(game, net, tree, probs, cpuct):
    """The reference's per-rollout search through the per-phase API:
    select -> leaf_positions -> net -> expand -> backup, one rollout at a
    time.  Returns the root policy of the last rollout."""
    import torch

    from alphatpu_torch.mcts import search as S

    root_pi = None
    for p in probs:
        root_was_expanded = tree.expanded[0].clone()
        path, node, leaf_action, alloc, pi = S.select(game, tree, p, cpuct)
        leaf_states = S.leaf_positions(game, tree, node, leaf_action, alloc)
        with torch.no_grad():
            logits, v = net(game.encode(leaf_states))
        prior = torch.softmax(logits, dim=-1).T.contiguous()
        _, done, result, newp = S.expand(game, tree, node, leaf_action, alloc,
                                         leaf_states, prior, True)
        root_pi = torch.where(root_was_expanded[None, :], pi, newp)
        S.backup(tree, path, leaf_states.player, v, done, result)
    return root_pi


@contextlib.contextmanager
def switches(env: dict):
    """The engine switches set to ``env`` (the others unset) inside the
    block, the caller's restored after it."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def selfplay_run(K, game, net, dev, label, env, chunks, owed_kernel, card,
                 lanes=LANES, chunk_rounds=CHUNK_ROUNDS):
    """Continuous selfplay at full width under the engine switches ``env``,
    ``chunks`` chained calls of ``chunk_rounds`` rounds on ``lanes`` lanes;
    checks the result and the launches the path owes.  Returns (launches,
    env-steps/s)."""
    import torch

    from alphatpu_torch.buffer import buffer_size, create_buffer
    from alphatpu_torch.selfplay import (
        SelfplayConfig, make_carry, selfplay_continuous,
    )

    with switches(env):
        G = lanes
        cfg = SelfplayConfig(num_games=G, rollouts=ROLLOUTS, cpuct=CPUCT,
                             rounds=chunk_rounds)
        buf = create_buffer(game, capacity=chunks * chunk_rounds * G,
                            device=dev)
        # warm-up (allocator, cuBLAS handles): one round, not counted
        selfplay_continuous(game, net, create_buffer(game, G, device=dev),
                            torch.Generator(device=dev).manual_seed(SEED + 7),
                            cfg._replace(rounds=1))
        torch.cuda.synchronize()
        carry = make_carry(game, G,
                           torch.Generator(device=dev).manual_seed(SEED), dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        totals = {}
        chunk_walls = []
        for _ in range(chunks):
            t1 = time.perf_counter()
            buf, stats, carry = selfplay_continuous(game, net, buf, None, cfg,
                                                    carry)
            stats["length_sum"] = stats["mean_length"] * stats[
                "games_finished"]
            for k, v in stats.items():
                totals[k] = totals.get(k, 0) + v
            torch.cuda.synchronize()
            chunk_walls.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        rounds = chunks * chunk_rounds
        launches = expect_launches(
            K, f"selfplay {label}",
            {owed_kernel: rounds * ROLLOUTS, "backup": rounds,
             **rules(game, rounds * (ROLLOUTS + 1))})
    totals = {k: float(v) for k, v in totals.items()}
    carried = float(stats["carried"])
    env_steps = totals["samples_written"] + carried
    mean_len = totals["length_sum"] / max(totals["games_finished"], 1.0)
    rate = env_steps / wall
    c = net.cfg
    print(f"selfplay {label}: {game.name} {c.depth}x{c.width}, {G} lanes, "
          f"{ROLLOUTS} rollouts, {rounds} rounds in {chunks} chained calls: "
          f"{rate:.1f} env-steps/s, wall {wall:.3f} s, "
          f"env-steps {env_steps:.0f}, samples written "
          f"{totals['samples_written']:.0f}, games finished "
          f"{totals['games_finished']:.0f}, mean game length "
          f"{mean_len:.2f}, illegal moves {totals['illegal_moves']:.0f}; "
          f"per call " + ", ".join(f"{chunk_rounds * G / w:.1f}"
                                   for w in chunk_walls)
          + f" env-steps/s  [{card}]")
    if totals["illegal_moves"] != 0:
        raise AssertionError(f"selfplay {label}: illegal moves")
    if rounds >= 2 * game.min_game_length and not (
            totals["samples_written"] > 0 and totals["games_finished"] > 0):
        raise AssertionError(f"selfplay {label}: no samples / no game")
    if env_steps != rounds * G:
        raise AssertionError(f"selfplay {label}: written + carried != "
                             "rounds x lanes")
    n = int(buffer_size(buf))
    if n != int(totals["samples_written"]):
        raise AssertionError(f"selfplay {label}: buffer size != samples")
    pol = buf.policy[:n]
    if not bool(torch.isfinite(pol).all()):
        raise AssertionError(f"selfplay {label}: non-finite policy rows")
    if not bool(((pol.sum(-1) - 1.0).abs() < 0.05).all()):
        raise AssertionError(f"selfplay {label}: policy rows do not sum to 1")
    values = torch.unique(buf.value[:n]).tolist()
    if not set(values) <= {0.0, 0.5, 1.0}:
        raise AssertionError(f"selfplay {label}: back-filled values {values}")
    return launches, rate


def family_runs(K, dev, card: str) -> dict:
    """Phase 8: continuous selfplay at level 1 for every family of
    FAMILIES, with its reference net.  Returns {game: launches}."""
    import torch

    from alphatpu_torch import graphs
    from alphatpu_torch.games import make_game
    from alphatpu_torch.nets import MLP, config_for_game

    rates, launches = {}, {}
    for name, (lanes, rounds) in FAMILIES.items():
        game = make_game(name)
        net = MLP.from_seed(config_for_game(game), SEED, device=dev)
        # the peak below is this family's: no other family's captured
        # rounds stay cached
        graphs.clear_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        launches[name], rates[name] = selfplay_run(
            K, game, net, dev, f"family {name}", {}, 1,
            "select_apply_packed", card, lanes=lanes, chunk_rounds=rounds)
        print(f"  {name}: A={game.max_actions}, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
        del net
        torch.cuda.empty_cache()
    print("env-steps/s per family in this run: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()) + f"  [{card}]")
    return launches


def card_outputs(net, dev):
    """``net``, held on the card, as a net of CPU tensors: each call
    evaluates on the card and returns the logits and values on the CPU."""
    def evaluate(x):
        logits, value = net(x.to(dev))
        return logits.cpu(), value.cpu()
    return evaluate


def path_shapes(K, dev, gen, shapes) -> dict:
    """Phase 9: for each (game, rollouts, lanes, cpuct, training) of
    ``shapes``, the level-1 search on the card against the CPU path, then
    every kernel against its plain version on a tree grown there.  The
    CPU path reads the card net's outputs: a value one float32 step
    apart moves a lane across the packed stats' value grid (on the CPU
    alone, gobang8's net in float64 rounded to float32 diverges 3 of 200
    lanes from the same net in float32), so the comparison holds the
    search, not two devices' matmul rounding.  Returns each kernel's
    largest error."""
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game

    errs = {k: 0.0 for k in KERNELS}
    for name, V, G, cpuct, training in shapes:
        g = make_game(name)
        net_g = MLP.from_seed(config_for_game(g), SEED, device=dev)
        search_vs_cpu(g, net_g, card_outputs(net_g, dev), dev, V, G, 1,
                      cpuct=cpuct, training=training)
        tree = init_tree(g, g.initial(G, dev), V)
        run_mcts(g, net_g, tree, rollouts=V - 2, cpuct=cpuct,
                 training=training, generator=gen)
        D = min(g.max_game_length, V)
        geo = K.walk_geometry(g.max_actions, G, V)
        shape = parity(K, tree, D, gen, cpuct, K.value_scale(V),
                       f"{name} A={g.max_actions} V={V} G={G} D={D} (walk "
                       f"<{geo.lanes},{geo.slots}>)", False)
        for k, r in shape.items():
            errs[k] = max(errs[k], r["err"])
        del net_g, tree
    return errs


def deep_trees(K, dev, gen, card) -> dict:
    """Phase 9's deep, narrow trees (``DEEP_TREES``), like those of a
    trained gobang13 net: the net from the seed with its policy head
    scaled up (a sharp prior), roots after random legal plies drawn with
    numpy.  The level-1 search on the card against the CPU path fed the
    card net's outputs, within 1 lane in 512; then a tree grown by the
    card's level-1 search at the record's lanes, whose largest depth must
    reach the floor, and all five kernels against their plain versions on
    it (0 diverged lanes).  Returns each kernel's largest error."""
    import torch

    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.deep_trees import (node_depths,
                                                opening_positions, sharpen)
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game

    name, V, G, Gc, factor, plies, floor = DEEP_TREES
    g = make_game(name)
    net = sharpen(MLP.from_seed(config_for_game(g), SEED, device=dev), factor)
    t0 = time.perf_counter()
    pos, _ = opening_positions(g, Gc, plies, SEED)
    search_vs_cpu(g, net, card_outputs(net, dev), dev, V, Gc, 1,
                  rollouts=V - 1, positions=pos, limit=math.ceil(Gc / 512))
    pos, _ = opening_positions(g, G, plies, SEED, device=dev)
    tree = init_tree(g, pos, V)
    run_mcts(g, net, tree, rollouts=V - 2, cpuct=CPUCT, training=True,
             generator=gen)
    depth = node_depths(tree.parent)
    print(f"deep trees, {name} (policy head x{factor:g}, roots after "
          f"{plies} random plies), {G} lanes, V={V}: depth reached largest "
          f"{depth.max()}, mean {depth[depth > 0].mean():.2f}, mean of each "
          f"lane's largest {depth.max(0).mean():.2f}")
    if depth.max() < floor:
        raise AssertionError(f"deep trees: largest depth {depth.max()} < "
                             f"{floor}")
    D = min(g.max_game_length, V)
    geo = K.walk_geometry(g.max_actions, G, V)
    errs = parity(K, tree, D, gen, CPUCT, K.value_scale(V),
                  f"deep trees {name} A={g.max_actions} V={V} G={G} D={D} "
                  f"(walk <{geo.lanes},{geo.slots}>)", False)
    print(f"deep trees: {time.perf_counter() - t0:.3f} s  [{card}]")
    return {k: r["err"] for k, r in errs.items()}


def pipeline_generation(K, dev, card: str, game_name: str,
                        lanes: int) -> None:
    """Phase 10: one generation of ``pipeline.run_generation`` at full
    width on ``game_name`` with its reference net - selfplay_generation
    on ``lanes`` games, one epoch, a 1024-game duel, Elo and a checkpoint
    with the buffer - with each stage's launches checked, then the
    checkpoint reloaded into a fresh state and compared with the live one
    bit for bit."""
    import math
    import tempfile

    import torch

    from alphatpu_torch import graphs
    from alphatpu_torch.duel import DuelConfig
    from alphatpu_torch.games import make_game
    from alphatpu_torch.nets import PARAM_NAMES, config_for_game
    from alphatpu_torch.pipeline import (
        PipelineConfig, init_pipeline, resume, run_generation,
    )
    from alphatpu_torch.selfplay import SelfplayConfig
    from alphatpu_torch.train import TrainConfig

    game = make_game(game_name)
    net_cfg = config_for_game(game)
    T = game.max_game_length
    duel = DuelConfig(num_games=GEN_DUEL[0], rollouts=GEN_DUEL[1])
    # stage -> (time, launch counts, graph counts) when its log line came
    marks = {}

    def log(line):
        print(f"  {line}")
        for stage in ("selfplay", "train", "duel"):
            if line.startswith(f"[gen 1] {stage}:"):
                marks[stage] = (time.perf_counter(), launch_counts(K),
                                dict(graphs.counts))

    with tempfile.TemporaryDirectory() as tmp:
        cfg = PipelineConfig(
            selfplay=SelfplayConfig(num_games=lanes, rollouts=ROLLOUTS,
                                    cpuct=CPUCT),
            train=TrainConfig(batch_size=8192), duel=duel,
            buffer_capacity=lanes * T, generations=1, seed=SEED,
            ckpt_dir=tmp, save_buffer=True, device=str(dev), log=log)
        state = init_pipeline(game, cfg)
        w0 = state.train_net.base.detach().clone()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        graphs.reset_counts()
        t0 = time.perf_counter()
        state, stats = run_generation(game, state, cfg)
        t_end = time.perf_counter()
        end_counts = launch_counts(K)
        # on the card the stages replay captured steps: selfplay's round
        # 0 and its tail, and each duel net's first round, run eagerly and
        # are captured; every round after replays
        sp, du = marks["selfplay"][2], marks["duel"][2]
        replayed = {"selfplay": (sp["captures"], sp["replays"]),
                    "duel": (du["captures"] - sp["captures"],
                             du["replays"] - sp["replays"])}
        print(f"graphs in the generation (captures, replays): {replayed}, "
              f"capture {du['capture_s']:.3f} s")
        if replayed != {"selfplay": (2, T - 1), "duel": (2, 2 * T - 2)}:
            raise AssertionError(f"generation {game_name}: graphs "
                                 f"{replayed}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(tmp, f))
                         for f in os.listdir(tmp))

        def delta(a, b):
            return {k: b[k] - a[k] for k in b}

        zero = {k: 0 for k in COUNTED}
        owed = {
            "selfplay": (zero, marks["selfplay"][1],
                         {"select_apply_packed": T * ROLLOUTS, "backup": T,
                          **rules(game, T * (ROLLOUTS + 1))}),
            "train": (marks["selfplay"][1], marks["train"][1], {}),
            "duel": (marks["train"][1], marks["duel"][1],
                     {"select_apply_packed": 2 * T * duel.rollouts,
                      "backup": 2 * T,
                      **rules(game, 2 * T * (duel.rollouts + 1))}),
            "checkpoint": (marks["duel"][1], end_counts, {}),
        }
        for stage, (a, b, want) in owed.items():
            got = delta(a, b)
            want = {k: want.get(k, 0) for k in COUNTED}
            print(f"launches in the generation's {stage}: {got}")
            if got != want:
                raise AssertionError(f"generation {game_name} {stage}: "
                                     f"launches {got}, owed {want}")
        if stats["illegal_moves"] != 0:
            raise AssertionError(f"generation {game_name}: illegal moves")
        if (stats["wins"] + stats["draws"] + stats["losses"]
                + stats["unfinished"]) != lanes:
            raise AssertionError(f"generation {game_name}: "
                                 "w+d+l+unfinished != games")
        if not math.isfinite(stats["loss"]):
            raise AssertionError(f"generation {game_name}: the loss is not "
                                 "finite")
        if torch.equal(w0, state.train_net.base):
            raise AssertionError(f"generation {game_name}: training changed "
                                 "no weight")
        if sum(stats["duel"]) + stats["duel_unfinished"] != duel.num_games:
            raise AssertionError(f"generation {game_name}: duel tally + "
                                 "unfinished != games")

        # the checkpoint, reloaded into a fresh state
        t1 = time.perf_counter()
        fresh = init_pipeline(game, cfg)
        resume(game, fresh, cfg)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t1
        pairs = [(f"best/{n}", getattr(fresh.best_net, n),
                  getattr(state.best_net, n)) for n in PARAM_NAMES]
        pairs += [(f"train/{n}", getattr(fresh.train_net, n),
                   getattr(state.train_net, n)) for n in PARAM_NAMES]
        pairs += [(f"opt/{f}/{n}", fresh.opt_state[f][n],
                   state.opt_state[f][n]) for f in ("mu", "nu")
                  for n in PARAM_NAMES]
        pairs += [("opt/count", fresh.opt_state["count"],
                   state.opt_state["count"]),
                  ("rng", fresh.rng.get_state(), state.rng.get_state())]
        pairs += [(f"buffer/{f}", getattr(fresh.buffer, f),
                   getattr(state.buffer, f))
                  for f in ("state", "policy", "player", "value", "fstate",
                            "cursor", "total")]
        bad = [k for k, a, b in pairs
               if a.dtype != b.dtype or not torch.equal(a, b)]
        scalars = [(fresh.elo, state.elo), (fresh.generation, 1),
                   (fresh.best_generation, state.best_generation)]
        if bad or any(a != b for a, b in scalars):
            raise AssertionError(f"{game_name} checkpoint reload differs: "
                                 f"{bad} {scalars}")
    t_sp, t_tr, t_du = stats["selfplay_s"], stats["train_s"], stats["duel_s"]
    n_upd = int(state.opt_state["count"])
    geo = K.walk_geometry(game.max_actions, lanes, ROLLOUTS)
    print(f"pipeline generation: {game_name} {net_cfg.depth}x"
          f"{net_cfg.width}, A={game.max_actions} (walk <{geo.lanes},"
          f"{geo.slots}>), selfplay {lanes} games x "
          f"{ROLLOUTS} rollouts ({stats['samples_written']} samples, "
          f"w/d/l/unfinished {stats['wins']}/{stats['draws']}/"
          f"{stats['losses']}/{stats['unfinished']}, illegal moves "
          f"{stats['illegal_moves']}): {t_sp:.3f} s; train {n_upd} updates "
          f"at batch 8192: {t_tr:.3f} s, loss {stats['loss']:.4f}; duel "
          f"{duel.num_games} games x {duel.rollouts} rollouts "
          f"(w/d/l {stats['duel']}, unfinished {stats['duel_unfinished']}): "
          f"{t_du:.3f} s; checkpoint {t_end - marks['duel'][0]:.3f} s "
          f"({ckpt_bytes / 2**20:.1f} MiB); generation {t_end - t0:.3f} s; "
          f"reload {t_load:.3f} s, equal to the live state bit for bit  "
          f"[{card}]")


class Tee:
    """A text stream that writes to several."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def cli_run(K, dev, card: str) -> dict:
    """Phase 11: ``alphatpu_torch.cli.main`` in process on ``dev`` - two
    tictactoe generations at CLI_GAMES games, then a third resumed from the
    checkpoint; then the loss replay of the third checkpoint (64 probe
    games against the perfect player, REPLAY_TEMP_MOVES sampled plies).
    Returns the launches of the three CLI runs."""
    import contextlib
    import io
    import tempfile

    from alphatpu_torch.benchmarks import ttt_loss_replay
    from alphatpu_torch.cli import main as cli_main
    from alphatpu_torch.games import make_game

    T, R, duel_r = 9, CLI_ROLLOUTS, CLI_DUEL_ROLLOUTS  # T: the move bound
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        stats_file = os.path.join(tmp, "stats.jsonl")
        common = ["--game", "tictactoe", "--samples", str(CLI_GAMES),
                  "--rollout", str(R), "--batchsize", "256", "--duel-games",
                  str(CLI_DUEL_GAMES), "--duel-rollouts", str(duel_r),
                  "--ckpt-dir", ck, "--stats-file", stats_file,
                  "--device", str(dev)]
        out = io.StringIO()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(Tee(sys.stdout, out)):
            rcs = (cli_main(common + ["--generation", "2"]),
                   cli_main(common + ["--generation", "3", "--resume"]))
        wall = time.perf_counter() - t0
        gens = 3
        launches = expect_launches(
            K, "the CLI (3 generations)",
            {"select_apply_packed": gens * (T * R + 2 * T * duel_r),
             "backup": gens * 3 * T,
             **rules(make_game("tictactoe"),
                     gens * (T * (R + 1) + 2 * T * (duel_r + 1)))})
        files = sorted(os.listdir(ck))
        with open(stats_file) as f:
            lines = [json.loads(x) for x in f]
        # the loss replay on the last checkpoint: its probe games against
        # the perfect player, each loss attributed
        t0 = time.perf_counter()
        replay = ttt_loss_replay.analyze(
            os.path.join(ck, "net3.npz"), REPLAY_TEMP_MOVES, SEED,
            device=dev, quiet=True)
        replay_wall = time.perf_counter() - t0
    if rcs != (0, 0):
        raise AssertionError(f"CLI exit codes {rcs}")
    if "resumed at generation 2" not in out.getvalue():
        raise AssertionError("CLI: the second run did not resume")
    if files != ["latest.json", "net1.npz", "net2.npz", "net3.npz"]:
        raise AssertionError(f"CLI: checkpoint files {files}")
    if [x["generation"] for x in lines] != [1, 2, 3]:
        raise AssertionError("CLI: stats lines")
    for x in lines:
        if x["illegal_moves"] != 0 or (x["wins"] + x["draws"] + x["losses"]
                                       + x["unfinished"]) != CLI_GAMES:
            raise AssertionError(f"CLI: generation {x['generation']}: {x}")
    print(f"CLI: tictactoe 6x128, 2 generations + 1 resumed, {wall:.3f} s; "
          f"illegal moves 0 in every generation; files {files}  [{card}]")
    losses = replay["losses"]
    counts = {
        "sampling_induced": sum(bool(v.get("sampling_induced"))
                                for v in losses),
        "search_error": sum(v.get("sampling_induced") is False
                            for v in losses),
        "no_blunder_found": sum("note" in v for v in losses),
    }
    if sum(replay["score"]) != 64 or len(losses) != replay["score"][2] or \
            sum(counts.values()) != len(losses):
        raise AssertionError(f"loss replay: {json.dumps(replay)}")
    print(f"loss replay (python -m alphatpu_torch.benchmarks."
          f"ttt_loss_replay): net3 vs the perfect player, temp_moves "
          f"{REPLAY_TEMP_MOVES}, seed {SEED}: net W/D/L "
          f"{'/'.join(map(str, replay['score']))}; verdicts {counts}; "
          f"{replay_wall:.3f} s  [{card}]")
    return launches


def cli_level2(K, dev, card: str) -> dict:
    """Phase 11, level 2: one tictactoe generation of
    ``alphatpu_torch.cli.main`` under ``ALPHATPU_PACK=2`` in a fresh
    checkpoint directory, the caller's environment restored after it:
    ``select_apply_packed1`` L2_ROLLOUTS times a move in selfplay and in
    both duel halves, no ``select_apply_packed``, one ``backup`` a
    search.  Returns its launches."""
    import tempfile

    from alphatpu_torch.cli import main as cli_main
    from alphatpu_torch.games import make_game

    T, R = 9, L2_ROLLOUTS
    with switches({"ALPHATPU_PACK": "2"}), \
            tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        stats_file = os.path.join(tmp, "stats.jsonl")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_main(["--game", "tictactoe", "--samples", str(CLI_GAMES),
                       "--rollout", str(R), "--batchsize", "256",
                       "--duel-games", str(CLI_DUEL_GAMES),
                       "--duel-rollouts", str(R), "--generation", "1",
                       "--ckpt-dir", ck, "--stats-file", stats_file,
                       "--device", str(dev)])
        wall = time.perf_counter() - t0
        launches = expect_launches(
            K, "the CLI's level-2 generation (ALPHATPU_PACK=2)",
            {"select_apply_packed1": T * R + 2 * T * R, "backup": 3 * T,
             **rules(make_game("tictactoe"), 3 * T * (R + 1))})
        files = sorted(os.listdir(ck))
        with open(stats_file) as f:
            lines = [json.loads(x) for x in f]
    if rc != 0 or files != ["latest.json", "net1.npz"] or len(lines) != 1:
        raise AssertionError(f"CLI level 2: exit code {rc}, files {files}, "
                             f"{len(lines)} stats lines")
    x = lines[0]
    if x["illegal_moves"] != 0 or (x["wins"] + x["draws"] + x["losses"]
                                   + x["unfinished"]) != CLI_GAMES:
        raise AssertionError(f"CLI level 2: {x}")
    print(f"CLI level 2: tictactoe 6x128, 1 generation under ALPHATPU_PACK=2, "
          f"{R} rollouts a move in selfplay and the duel, {wall:.3f} s; "
          f"illegal_moves {x['illegal_moves']}, unfinished {x['unfinished']}; "
          f"files {files}  [{card}]")
    return launches


def evaluation_and_play(K, dev, card: str) -> dict:
    """Phase 12: the evaluation and play paths, each run as a user calls
    it (captured: its steps replayed from CUDA graphs) and eagerly
    (``captured=False``) from the same generator state, the two equal bit
    for bit, each with its launches checked and both times printed -
    ``eval_vs_probe`` on connect4 (the reference net, PROBE_GAMES games,
    ROLLOUTS rollouts, against a depth-PROBE_DEPTH ``LineProbe``; picks,
    trace and the probe's host seconds), ``eval_vs_random`` on tictactoe,
    and PLAY_MOVES moves of the interactive engine (a G = 1 search of
    PLAY_READOUT rollouts) on connect4 (actions and root policies); then
    kernels 1 and 2 against their plain versions on a tree grown at a
    position of the probe games (G = PROBE_GAMES) and at the interactive
    engine's position (G = 1), and the G = 1 search on the card against
    the CPU path.  Returns {kernel: max abs error} of the two kernels'
    checks."""
    import numpy as np
    import torch

    from alphatpu_torch import graphs
    from alphatpu_torch.eval import EvalConfig, eval_vs_random
    from alphatpu_torch.games import make_game
    from alphatpu_torch.games.base import where_games
    from alphatpu_torch.interactive import make_engine
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game
    from alphatpu_torch.probe import eval_vs_probe, probe_for_game

    t_phase = time.perf_counter()
    pair = ("select_apply_packed", "backup")
    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game), SEED, device=dev)

    def both(label, fn, owed):
        """``fn(generator, captured)`` captured, then eagerly, each from
        a generator seeded alike: {captured: (result, wall s, generator
        state, graph counts)}, launches as ``owed(result)`` says."""
        out = {}
        for captured in (True, False):
            gen = torch.Generator(device=dev).manual_seed(SEED + 11)
            graphs.clear_cache()
            torch.cuda.synchronize()
            K.reset_launch_counts()
            graphs.reset_counts()
            t0 = time.perf_counter()
            r = fn(gen, captured)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            expect_launches(K, f"{label}, "
                            f"{'captured' if captured else 'eager'}",
                            owed(r))
            out[captured] = (r, wall, gen.get_state(), dict(graphs.counts))
        if not torch.equal(out[True][2], out[False][2]):
            raise AssertionError(f"{label}: the generator's state after "
                                 "the captured run differs from the eager")
        return out

    def timing(out) -> str:
        (_, c_wall, _, counts), (_, e_wall, _, _) = out[True], out[False]
        return (f"captured {c_wall:.3f} s ({counts['captures']} captures, "
                f"{counts['capture_s']:.3f} s, {counts['replays']} "
                f"replays), eager {e_wall:.3f} s")

    # eval_vs_probe: every ply searches all games; the probe's seconds on
    # the host are the rest of the wall
    G, R = PROBE_GAMES, ROLLOUTS
    probe = probe_for_game(game, PROBE_DEPTH)
    probe_s = []
    best_action = probe.best_action

    def timed_best_action(*args):
        t0 = time.perf_counter()
        a = best_action(*args)
        probe_s[-1] += time.perf_counter() - t0
        return a

    probe.best_action = timed_best_action

    def probe_run(gen, captured):
        probe_s.append(0.0)
        return eval_vs_probe(game, net, gen, probe, num_games=G, rollouts=R,
                             cpuct=CPUCT, seed=SEED, trace=True, device=dev,
                             captured=captured)

    out = both("eval_vs_probe (connect4)", probe_run,
               lambda r: {"select_apply_packed": len(r[3]["records"]) * R,
                          "backup": len(r[3]["records"]),
                          **rules(game, len(r[3]["records"]) * (R + 1))})
    (*wdl, trace), (*e_wdl, e_trace) = out[True][0], out[False][0]
    plies = len(trace["records"])
    if wdl != e_wdl or len(e_trace["records"]) != plies or any(
            not np.array_equal(a[k], b[k])
            for a, b in zip(trace["records"], e_trace["records"])
            for k in ("action", "greedy", "sampled", "alive")) or \
            not np.array_equal(trace["result"], e_trace["result"]):
        raise AssertionError("eval_vs_probe: captured != eager")
    w, d, l = wdl
    if w + d + l != G or not game.min_game_length <= plies <= \
            game.max_game_length:
        raise AssertionError(f"eval_vs_probe: {w}/{d}/{l}, {plies} plies")
    print(f"eval_vs_probe: connect4 {net.cfg.depth}x{net.cfg.width} (random "
          f"weights, seed {SEED}) vs LineProbe depth {probe.depth}, {G} games"
          f" x {R} rollouts: net W/D/L {w}/{d}/{l}, {plies} plies; picks, "
          f"trace and generator state captured = eager bit for bit; "
          f"{timing(out)}; the probe on the host {probe_s[0]:.3f} s "
          f"captured, {probe_s[1]:.3f} s eager, so the rest (the net's "
          f"search, its copies) {out[True][1] - probe_s[0]:.3f} s captured, "
          f"{out[False][1] - probe_s[1]:.3f} s eager  [{card}]")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    # a tree grown at the probe games' positions half way through
    positions = game.initial(G, dev)
    for rec in trace["records"][:plies // 2]:
        alive = torch.from_numpy(rec["alive"]).to(dev)
        act = torch.from_numpy(rec["action"]).to(dev)
        positions = where_games(alive, game.play(positions, act), positions)
    tree = init_tree(game, positions, R)
    run_mcts(game, net, tree, rollouts=R - 2, cpuct=CPUCT, training=False,
             generator=gen)
    D = min(game.max_game_length, R)
    errs = parity(K, tree, D, gen, CPUCT, K.value_scale(R),
                  f"eval_vs_probe's tree, connect4 ply {plies // 2} A="
                  f"{game.max_actions} V={R} G={G} D={D}", False,
                  kernels=pair)
    del tree

    # eval_vs_random: 2 halves x T plies, every ply searched
    ttt = make_game("tictactoe")
    ttt_net = MLP.from_seed(config_for_game(ttt), SEED, device=dev)
    cfg = EvalConfig()
    T = ttt.max_game_length
    out = both("eval_vs_random (tictactoe)",
               lambda gen, captured: eval_vs_random(
                   ttt, ttt_net, gen, cfg, device=dev, captured=captured),
               lambda r: {"select_apply_packed": 2 * T * cfg.rollouts,
                          "backup": 2 * T,
                          **rules(ttt, 2 * T * (cfg.rollouts + 1))})
    w, d, l = out[True][0]
    if (w, d, l) != out[False][0] or w + d + l != cfg.num_games:
        raise AssertionError(f"eval_vs_random: {w}/{d}/{l} captured, "
                             f"{out[False][0]} eager")
    print(f"eval_vs_random: tictactoe {ttt_net.cfg.depth}x"
          f"{ttt_net.cfg.width} (random weights) vs the uniform mover, "
          f"{cfg.num_games} games x {cfg.rollouts} rollouts: net W/D/L "
          f"{w}/{d}/{l}, captured = eager; {timing(out)}  [{card}]")

    # the interactive engine: one game, PLAY_MOVES engine moves (the first
    # captured move runs eagerly and captures; the rest replay)
    def play(gen, captured):
        choose = make_engine(game, net, PLAY_READOUT, CPUCT,
                             captured=captured)
        pos = game.initial(1, dev)
        moves, pis, walls = [], [], []
        for _ in range(PLAY_MOVES):
            t0 = time.perf_counter()
            action, pi = choose(pos, gen)
            walls.append(time.perf_counter() - t0)
            if not bool(game.legal_mask(pos)[0, action]) or not bool(
                    torch.isfinite(pi).all()):
                raise AssertionError(f"interactive engine: move {action}, "
                                     f"pi {pi}")
            moves.append(action)
            pis.append(pi)
            pos = game.play(pos, torch.tensor([action], device=dev))
        return moves, pis, walls, pos

    out = both(f"{PLAY_MOVES} interactive engine moves (G=1)", play,
               lambda r: {"select_apply_packed": PLAY_MOVES * PLAY_READOUT,
                          "backup": PLAY_MOVES,
                          **rules(game, PLAY_MOVES * PLAY_READOUT)})
    (moves, pis, walls, pos), (e_moves, e_pis, e_walls, _) = (
        out[True][0], out[False][0])
    if moves != e_moves or any(not torch.equal(a, b)
                               for a, b in zip(pis, e_pis)):
        raise AssertionError(f"interactive engine: captured {moves} != "
                             f"eager {e_moves}")
    print(f"interactive engine: connect4, G=1, {PLAY_READOUT} rollouts a "
          f"move, moves {moves}, actions and root policies captured = "
          f"eager: captured {sum(walls[1:]) / (PLAY_MOVES - 1):.4f} s a "
          f"move after the first ({walls[0]:.3f} s: eager, then the "
          f"capture), eager {sum(e_walls) / PLAY_MOVES:.3f} s a move  "
          f"[{card}]")
    print("  board after them:\n    " + game.render(pos).replace(
        "\n", "\n    "))
    geo = K.walk_geometry(game.max_actions, 1, PLAY_READOUT)
    print(f"  G=1 walk geometry: {geo}; backup {K.backup_geometry(1)}")
    tree = init_tree(game, pos, PLAY_READOUT)
    run_mcts(game, net, tree, rollouts=PLAY_READOUT - 2, cpuct=CPUCT,
             training=False, generator=gen)
    D = min(game.max_game_length, PLAY_READOUT)
    one = parity(K, tree, D, gen, CPUCT, K.value_scale(PLAY_READOUT),
                 f"the interactive engine's tree, connect4 A="
                 f"{game.max_actions} V={PLAY_READOUT} G=1 D={D}", False,
                 kernels=pair)
    for k, r in one.items():
        errs[k]["err"] = max(errs[k]["err"], r["err"])
    net_cpu = MLP.from_seed(config_for_game(game), SEED,
                            device=torch.device("cpu"))
    search_vs_cpu(game, net, net_cpu, dev, PLAY_READOUT, 1, 1,
                  training=False)
    graphs.clear_cache()
    print(f"evaluation and play: {time.perf_counter() - t_phase:.3f} s  "
          f"[{card}]")
    return {k: r["err"] for k, r in errs.items()}


def _dp_rank(world, ckpt_dir, card):
    """Phase 13's rank: one connect4 generation of ``run_generation`` over
    the world (2 ranks sharing the card over gloo), then this rank's side
    of the checks.  Returns the launches, the stats, the parameters, the
    time of the gradient bucket's all_reduce, whether the checkpoint
    reloads into the world bit for bit and (rank 0) the lanes where its
    selfplay differs from a one-process run of its lanes on the same
    stream."""
    from functools import partial

    import torch

    from alphatpu_torch.buffer import create_buffer
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.nets import MLP, PARAM_NAMES, apply_inference
    from alphatpu_torch.parallel.mesh import all_reduce, rank_generator
    from alphatpu_torch.pipeline import init_pipeline, resume, run_generation
    from alphatpu_torch.selfplay import make_carry, selfplay_continuous

    game, cfg = _dp_config(world, ckpt_dir)
    marks = {}  # stage -> (time, launch counts) when rank 0 logged it

    def log(line):
        print(f"  rank 0: {line}", flush=True)
        for stage in ("selfplay", "train", "duel"):
            if line.startswith(f"[gen 1] {stage}:"):
                marks[stage] = (time.perf_counter(), launch_counts(K))

    cfg.log = log
    state = init_pipeline(game, cfg)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, stats = run_generation(game, state, cfg)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = launch_counts(K)

    # the gradient bucket's all_reduce, as train_epoch sends it
    bucket = torch.cat([getattr(state.train_net, n).detach().reshape(-1)
                        for n in PARAM_NAMES])
    all_reduce(bucket)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(DP_ALLREDUCE_REPS):
        all_reduce(bucket)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t1) / DP_ALLREDUCE_REPS * 1e3

    # the checkpoint (gathered, written by rank 0) back into the world
    fresh = init_pipeline(game, cfg)
    resume(game, fresh, cfg)
    pairs = [(getattr(fresh.best_net, n), getattr(state.best_net, n))
             for n in PARAM_NAMES]
    pairs += [(getattr(fresh.train_net, n), getattr(state.train_net, n))
              for n in PARAM_NAMES]
    pairs += [(fresh.opt_state[f][n], state.opt_state[f][n])
              for f in ("mu", "nu") for n in PARAM_NAMES]
    pairs += [(fresh.opt_state["count"], state.opt_state["count"]),
              (fresh.rng.get_state(), state.rng.get_state())]
    pairs += [(getattr(fresh.buffer, f), getattr(state.buffer, f))
              for f in ("state", "policy", "player", "value", "fstate",
                        "cursor", "total")]
    pairs += [(a, b) for a, b in zip(fresh.sp_carry.positions,
                                     state.sp_carry.positions)]
    pairs += [(getattr(fresh.sp_carry, f), getattr(state.sp_carry, f))
              for f in ("count", "enc", "pol", "player")]
    reload_equal = all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in pairs)

    out = {"counts": counts, "stats": stats, "t_gen": t_end - t0,
           "allreduce_ms": allreduce_ms, "bucket": bucket.numel(),
           "reload_equal": reload_equal,
           "total": int(state.buffer.total[0]),
           "train": {n: getattr(state.train_net, n).detach().cpu().numpy()
                     for n in PARAM_NAMES},
           "best": {n: getattr(state.best_net, n).detach().cpu().numpy()
                    for n in PARAM_NAMES}}
    if world.rank == 0:
        out["stages"] = {k: (v[0] - t0, v[1]) for k, v in marks.items()}
        out["t_ckpt"] = t_end - marks["duel"][0]
        # the same lanes in one process: the first draw of the run's
        # stream is rank 0's selfplay stream
        G = cfg.selfplay.num_games // world.size
        net = MLP.from_seed(state.best_net.cfg, SEED, device=world.device)
        sp_gen = rank_generator(
            torch.Generator(device=world.device).manual_seed(SEED), world)
        buf, _, carry = selfplay_continuous(
            game, partial(apply_inference, net),
            create_buffer(game, state.buffer.capacity, device=world.device),
            None, cfg.selfplay._replace(num_games=G),
            make_carry(game, G, sp_gen, world.device))
        live, one = state.sp_carry, carry
        leaves = list(zip(live.positions, one.positions)) + [
            (getattr(live, f), getattr(one, f))
            for f in ("count", "enc", "pol", "player")]
        bad = torch.zeros((G,), dtype=torch.bool, device=world.device)
        for a, b in leaves:
            bad |= (a != b).reshape(G, -1).any(1)
        out["diverged"] = int(bad.sum())
        out["buffer_equal"] = all(torch.equal(getattr(buf, f),
                                              getattr(state.buffer, f))
                                  for f in ("state", "policy", "player",
                                            "value", "fstate", "cursor",
                                            "total"))
        out["lanes"] = G
    return out


def _dp_config(world, ckpt_dir):
    """Phase 13's generation: connect4 4x512 at LANES lanes over the
    world, DP_ROUNDS continuous rounds, one epoch at the CLI's batch, a
    duel cut to DP_DUEL and a checkpoint with the buffer."""
    from alphatpu_torch.duel import DuelConfig
    from alphatpu_torch.games import make_game
    from alphatpu_torch.pipeline import PipelineConfig
    from alphatpu_torch.selfplay import SelfplayConfig
    from alphatpu_torch.train import TrainConfig

    games, rollouts, moves = DP_DUEL
    return make_game("connect4"), PipelineConfig(
        selfplay=SelfplayConfig(num_games=LANES, rollouts=ROLLOUTS,
                                cpuct=CPUCT, continuous=True,
                                rounds=DP_ROUNDS),
        train=TrainConfig(batch_size=8192),
        duel=DuelConfig(num_games=games, rollouts=rollouts, max_moves=moves),
        buffer_capacity=LANES * DP_ROUNDS, generations=1, seed=SEED,
        ckpt_dir=ckpt_dir, save_buffer=True, devices=world.size,
        device=str(world.device))


def data_parallel(K, dev, card: str) -> None:
    """Phase 13: data-parallel training on one card.  DP_RANKS processes
    share ``dev`` over gloo and run one connect4 generation at full width
    (LANES lanes in all); each rank's launches must be what it owes, rank
    0's selfplay must equal a one-process run of its lanes on the same
    stream (at most 2 diverged lanes), the averaged update must equal a
    one-process emulation (rtol 2e-5), the ranks' parameters must be equal
    bit for bit, and the checkpoint must reload into the world of
    DP_RANKS bit for bit.  Then a world of one NCCL rank all_reduces the
    gradient bucket on the card.  Two ranks on one card measure no
    scaling."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from alphatpu_torch.buffer import ReplayBuffer
    from alphatpu_torch.nets import MLP, PARAM_NAMES, config_for_game
    from alphatpu_torch.parallel.mesh import (
        World, all_reduce, free_init_method, make_world, rank_generator,
        run_ranks,
    )
    from alphatpu_torch.train import (
        TrainConfig, adam_init, adam_update, loss_fn,
    )

    t_phase = time.perf_counter()
    D = DP_RANKS
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(_dp_rank, D, tmp, card, device=str(dev),
                         backend="gloo", timeout=DP_TIMEOUT)
        with np.load(os.path.join(tmp, "buffer.npz")) as z:
            shards = {k[1:]: z[k] for k in z.files}
    game, cfg = _dp_config(World(0, D, dev), None)
    stats = outs[0]["stats"]
    _, _, duel_moves = DP_DUEL
    sp_plays = DP_ROUNDS * (ROLLOUTS + 1)
    duel_plays = 2 * duel_moves * (cfg.duel.rollouts + 1)
    owed = {"select_apply_packed": DP_ROUNDS * ROLLOUTS
            + 2 * duel_moves * cfg.duel.rollouts,
            "backup": DP_ROUNDS + 2 * duel_moves,
            **rules(game, sp_plays + duel_plays)}
    for r, out in enumerate(outs):
        want = {k: owed.get(k, 0) for k in COUNTED}
        print(f"launches in rank {r}'s generation: {out['counts']}")
        if out["counts"] != want:
            raise AssertionError(f"rank {r}: launches {out['counts']}, owed "
                                 f"{want}")
        if not out["reload_equal"]:
            raise AssertionError(f"rank {r}: the checkpoint does not reload "
                                 "bit for bit")
        for which in ("train", "best"):
            for n in PARAM_NAMES:
                if not np.array_equal(out[which][n], outs[0][which][n]):
                    raise AssertionError(f"rank {r}: {which}/{n} differs "
                                         "from rank 0's")
    if stats["illegal_moves"] != 0:
        raise AssertionError("data parallel: illegal moves")
    first = outs[0]
    stages = first["stages"]
    for stage, start, kernel1, backups, plays in (
            ("selfplay", None, DP_ROUNDS * ROLLOUTS, DP_ROUNDS, sp_plays),
            ("duel", "train", 2 * duel_moves * cfg.duel.rollouts,
             2 * duel_moves, duel_plays)):
        a = {k: 0 for k in COUNTED} if start is None else stages[start][1]
        got = {k: stages[stage][1][k] - a[k] for k in COUNTED}
        print(f"  rank 0's launches in the {stage}: {got}")
        want = {k: 0 for k in COUNTED}
        want.update(select_apply_packed=kernel1, backup=backups,
                    **rules(game, plays))
        if got != want:
            raise AssertionError(f"rank 0's {stage}: launches {got}, owed "
                                 f"{want}")
    if first["diverged"] > 2:
        raise AssertionError(f"rank 0's selfplay: {first['diverged']} lanes "
                             "differ from the one-process run")

    # the averaged update, emulated in this process from the checkpoint's
    # shards and the ranks' train streams
    net_cfg = config_for_game(game)
    net = MLP.from_seed(net_cfg, SEED, device=dev, trainable=True)
    opt = adam_init(net)
    local = TrainConfig(batch_size=cfg.train.batch_size // D)
    cap = cfg.buffer_capacity // D
    bufs, gens = [], []
    for r in range(D):
        bufs.append(ReplayBuffer(**{
            f: torch.from_numpy(v[r:r + 1] if f in ("cursor", "total")
                                else v[r * cap:(r + 1) * cap]).to(dev)
            for f, v in shards.items()}))
        g = torch.Generator(device=dev).manual_seed(SEED)
        rank_generator(g, World(r, D, dev))  # the selfplay stream
        gens.append(rank_generator(g, World(r, D, dev)))
    sizes = [min(int(b.total[0]), cap) for b in bufs]
    n_updates = max(min(sum(sizes), local.max_samples)
                    // cfg.train.batch_size - 1, 1)
    params = [getattr(net, n) for n in PARAM_NAMES]
    for _ in range(n_updates):
        grads = []
        for b, g, size in zip(bufs, gens, sizes):
            idx = torch.randint(0, max(size, 1), (local.batch_size,),
                                generator=g, device=dev)
            batch = (b.state[idx].float(), b.policy[idx], b.value[idx],
                     b.fstate[idx].float())
            grads.append(torch.autograd.grad(
                loss_fn(net, *batch, local.feature_weight), params))
        mean = {n: sum(gs[i] for gs in grads) / D
                for i, n in enumerate(PARAM_NAMES)}
        opt = adam_update(net, mean, opt, local)
    err = 0.0
    for n in PARAM_NAMES:
        got = torch.from_numpy(first["train"][n]).to(dev)
        want = getattr(net, n).detach()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
        err = max(err, float((got - want).abs().max()))

    # one NCCL rank: the bucket's all_reduce on the card
    world = make_world(1, dev, rank=0, backend="nccl",
                       init_method=free_init_method())
    try:
        bucket = torch.cat([p.detach().reshape(-1) for p in params])
        want = bucket.clone()  # the sum over a world of one rank
        all_reduce(bucket)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_ALLREDUCE_REPS):
            all_reduce(bucket)
        torch.cuda.synchronize()
        nccl_ms = (time.perf_counter() - t0) / DP_ALLREDUCE_REPS * 1e3
        if dist.get_backend() != "nccl" or not torch.equal(bucket, want):
            raise AssertionError("the NCCL world's all_reduce")
    finally:
        dist.destroy_process_group()
    print(f"data parallel: connect4 {net_cfg.depth}x{net_cfg.width}, {D} "
          f"gloo ranks on one card, {LANES} lanes ({first['lanes']} a rank) "
          f"x {ROLLOUTS} rollouts, {DP_ROUNDS} continuous rounds: selfplay "
          f"{stats['selfplay_s']:.3f} s (illegal moves "
          f"{stats['illegal_moves']}, samples {stats['samples_written']}, "
          f"rank totals {[o['total'] for o in outs]}); train "
          f"{stats['train_s']:.3f} s ({n_updates} update(s) at batch "
          f"{cfg.train.batch_size}, loss {stats['loss']:.4f}); duel "
          f"{stats['duel_s']:.3f} s ({cfg.duel.num_games} games x "
          f"{cfg.duel.rollouts} rollouts, {duel_moves} moves: w/d/l "
          f"{stats['duel']}, unfinished {stats['duel_unfinished']}); "
          f"checkpoint {first['t_ckpt']:.3f} s; generation "
          f"{first['t_gen']:.3f} s (rank 1 {outs[1]['t_gen']:.3f} s)  "
          f"[{card}]")
    print(f"  rank 0's selfplay vs one process on the same stream: "
          f"diverged lanes {first['diverged']}/{first['lanes']}, buffer "
          f"equal {first['buffer_equal']}; averaged update vs the "
          f"one-process emulation: max abs err {err:.3g}; ranks' parameters "
          f"equal bit for bit; checkpoint reloaded into the world of {D} "
          f"bit for bit")
    print(f"  gradient bucket all_reduce ({first['bucket']} float32): gloo "
          f"through the host, 2 ranks {first['allreduce_ms']:.3f} ms / "
          f"{outs[1]['allreduce_ms']:.3f} ms; NCCL, one rank "
          f"{nccl_ms:.3f} ms  [{card}]")
    print(f"data parallel: {time.perf_counter() - t_phase:.3f} s  [{card}]")


def zoo_searches(K, dev, card: str) -> None:
    """Phase 14: each zoo net at connect4's reference width (512, depth 4;
    the conv tower at 64 channels, depth 4): a 64-rollout level-1 search
    of LANES lanes (launches 64 and 1), then a search on the card against
    the CPU path at SMALL_G lanes (at most 2 diverged); then ZOO_ROUNDS
    rounds of continuous selfplay with res2."""
    import torch

    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import config_for_game
    from alphatpu_torch.nets.zoo import make_conv_net, make_net

    t_phase = time.perf_counter()
    game = make_game("connect4")
    cfg = config_for_game(game)
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    rates = {}
    for name in ZOO_NETS:
        if name == "conv":
            nets = [make_conv_net(game, 64, 4, SEED, device=d)
                    for d in (dev, cpu)]
            shape = "64 channels x 4"
        else:
            nets = [make_net(name, cfg, SEED, device=d) for d in (dev, cpu)]
            shape = f"{cfg.depth}x{cfg.width}"
        tree = init_tree(game, game.initial(LANES, dev), ROLLOUTS)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        _, pi = run_mcts(game, nets[0], tree, rollouts=ROLLOUTS,
                         cpuct=CPUCT, training=True, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_launches(K, f"the {name} search",
                        {"select_apply_packed": ROLLOUTS, "backup": 1,
                         **rules(game, ROLLOUTS)})
        root = tree.visits[:, 0, :].sum(0)
        if not bool((root == ROLLOUTS - 1).all()) or not bool(
                torch.isfinite(pi).all()):
            raise AssertionError(f"zoo {name}: root visits or policy")
        rates[name] = LANES / wall
        print(f"zoo {name} ({shape}): level-1 search, {LANES} lanes x "
              f"{ROLLOUTS} rollouts: {wall:.3f} s, {rates[name]:.1f} "
              f"env-steps/s  [{card}]")
        del tree
        search_vs_cpu(game, nets[0], nets[1], dev, ROLLOUTS, SMALL_G, 1)
    res2 = make_net("res2", cfg, SEED, device=dev)
    selfplay_run(K, game, res2, dev, "zoo res2", {}, 1,
                 "select_apply_packed", card, chunk_rounds=ZOO_ROUNDS)
    print("zoo search env-steps/s in this run: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()) + f"  [{card}]")
    print(f"zoo: {time.perf_counter() - t_phase:.3f} s  [{card}]")


def bench_runs(card: str) -> None:
    """Phase 15: the bench's ``measure`` on connect4 (LANES lanes,
    BENCH_ROUNDS rounds in chunks of BENCH_CHUNK) for each of BENCH_RUNS,
    one JSON line each; then the ablation's ABLATE_VARIANTS at LANES
    lanes, captured and eager.  ``measure`` and the ablation raise on launches that differ
    from what is owed; ``measure`` on an illegal move or repeats that
    differ."""
    from alphatpu_torch import bench
    from alphatpu_torch.benchmarks import ablate_rollout

    t_phase = time.perf_counter()
    for kw in BENCH_RUNS:
        t0 = time.perf_counter()
        r = bench.measure("connect4", games=LANES, rollouts=ROLLOUTS,
                          rounds=BENCH_ROUNDS, chunk=BENCH_CHUNK, seed=SEED,
                          **kw)
        ex = r["extra"]
        if (ex["launches"] != ex["launches_owed"] or ex["illegal_moves"]
                or ex["env_steps"] != LANES * BENCH_ROUNDS
                or not math.isfinite(r["value"]) or r["value"] <= 0):
            raise AssertionError(f"bench {kw}: {json.dumps(r)}")
        # every timed round, and every call's tail, a replay of what the
        # warm-up captured
        if not ex["captured"] or (ex["graph_replays"], ex["graph_captures"]) \
                != (BENCH_ROUNDS + BENCH_ROUNDS // BENCH_CHUNK, 0):
            raise AssertionError(f"bench {kw}: rounds not replayed: "
                                 f"{json.dumps(r)}")
        print(json.dumps(r))
        print(f"bench {kw}: {time.perf_counter() - t0:.3f} s with the "
              f"warm-up; spread {ex['spread']:.4f}  [{card}]")
    # each variant's move captured (replayed, the device's work) and eager
    out = {captured: ablate_rollout.ablate(
        "connect4", LANES, ROLLOUTS, names=ABLATE_VARIANTS, device="cuda",
        log=lambda line: print(f"ablate {line}"), captured=captured)
        for captured in (True, False)}
    for name in ABLATE_VARIANTS:
        c, e = out[True][name], out[False][name]
        if c["launches"] != e["launches"]:
            raise AssertionError(f"ablate {name}: captured launches "
                                 f"{c['launches']}, eager {e['launches']}")
        print(f"ablate {name}: captured {c['ms_per_move']:.1f} ms a move, "
              f"eager {e['ms_per_move']:.1f} ms; launches in the timed "
              f"moves {c['launches']}  [{card}]")
    print(f"bench and ablation: {time.perf_counter() - t_phase:.3f} s  "
          f"[{card}]")


def expect_bf16(K, what: str) -> None:
    """Every launch of the three-plane kernels since the last reset was
    of their bf16 instantiation: the search ran on bf16 stat planes."""
    got = {name: (getattr(K, name).launches, getattr(K, name).launches_bf16)
           for name in BF16_KERNELS}
    print(f"bf16 launches in {what}: " + ", ".join(
        f"{name} {b} of {n}" for name, (n, b) in got.items()))
    if any(n != b for n, b in got.values()):
        raise AssertionError(f"{what}: launches on f32 planes {got}")


def bf16_stats_path(K, dev, card: str) -> dict:
    """Phase 16: the slice end to end under ALPHATPU_BF16_STATS=1, every
    search storing prior, wsum and visits as bf16 planes and running the
    f32 family's engine on them (select_apply, backup).  A search on the
    card against the CPU path (connect4, SMALL_G lanes); the per-phase API
    on bf16 planes against run_mcts (LANES lanes, bit for bit); the bench's
    measure at full width (connect4 4x512, LANES lanes, ROLLOUTS rollouts,
    BENCH_ROUNDS rounds in chunks of BENCH_CHUNK) with its launches as owed
    (select_apply ROLLOUTS a round, backup 1, the packed kernels 0) and no
    illegal move; a BF16_DUEL duel half; a short eval_vs_probe on
    connect4.  Each path's
    launches are all bf16 launches.  Returns the launches of the bench's
    last timed generation, and select's of the per-phase search."""
    import torch

    from alphatpu_torch import bench
    from alphatpu_torch.duel import DuelConfig, duel_half
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree, stat_dtype_for
    from alphatpu_torch.nets import MLP, config_for_game
    from alphatpu_torch.probe import eval_vs_probe, probe_for_game

    t_phase = time.perf_counter()
    saved = os.environ.get("ALPHATPU_BF16_STATS")
    os.environ["ALPHATPU_BF16_STATS"] = "1"
    try:
        game = make_game("connect4")
        cfg = config_for_game(game)
        net = MLP.from_seed(cfg, SEED, device=dev)
        net_cpu = MLP.from_seed(cfg, SEED, device=torch.device("cpu"))
        bf16 = torch.bfloat16
        if stat_dtype_for(ROLLOUTS) != bf16:
            raise AssertionError("ALPHATPU_BF16_STATS: stat_dtype_for")

        K.reset_launch_counts()
        search_vs_cpu(game, net, net_cpu, dev, ROLLOUTS, SMALL_G, 0,
                      stat_dtype=bf16)
        expect_launches(K, "the bf16 search on the card",
                        {"select_apply": ROLLOUTS, "backup": 1,
                         **rules(game, ROLLOUTS)})
        expect_bf16(K, "the bf16 search on the card")

        # the per-phase API on bf16 planes against the engine's run_mcts
        # on the same uniforms, bit for bit (phase 6 on bf16)
        V, G = ROLLOUTS, LANES
        D = min(game.max_game_length, V)
        probs = torch.rand((V, D, G), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 19))
        tree = init_tree(game, game.initial(G, dev), V, stat_dtype=bf16)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        pi = phase_search(game, net, tree, probs, CPUCT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phase_launches = expect_launches(
            K, "the per-phase search on bf16 planes",
            {"select": V, "backup": V, **rules(game, V)})
        expect_bf16(K, "the per-phase search on bf16 planes")
        ref = init_tree(game, game.initial(G, dev), V, stat_dtype=bf16)
        _, ref_pi = run_mcts(game, net, ref, rollouts=V, cpuct=CPUCT,
                             training=True, probs=probs)
        fields = ("parent", "action_from", "expanded", "next_idx", "prior",
                  "wsum", "visits")
        bad = diverged_lanes(
            tuple(getattr(tree, f) for f in fields) + (pi,),
            tuple(getattr(ref, f) for f in fields) + (ref_pi,))
        print(f"per-phase search on bf16 planes: {G} lanes, {V} rollouts in "
              f"{wall:.3f} s; lanes that differ from run_mcts on bf16 "
              f"planes: {int(bad.sum())}/{G}  [{card}]")
        if int(bad.sum()) != 0:
            raise AssertionError("per-phase search on bf16 != run_mcts")
        del tree, ref, probs

        t0 = time.perf_counter()
        r = bench.measure("connect4", games=LANES, rollouts=ROLLOUTS,
                          rounds=BENCH_ROUNDS, chunk=BENCH_CHUNK, seed=SEED)
        ex = r["extra"]
        owed = {"select_apply": ROLLOUTS * BENCH_ROUNDS,
                "backup": BENCH_ROUNDS,
                **rules(game, (ROLLOUTS + 1) * BENCH_ROUNDS)}
        print(json.dumps(r))
        if (ex["launches"] != ex["launches_owed"]
                or ex["launches"] != {n: owed.get(n, 0) for n in COUNTED}
                or ex["illegal_moves"] or ex["stat_dtype"] != "bfloat16"
                or ex["pack_level"] != 0
                or not r["metric"].endswith("_bf16stats")
                or ex["env_steps"] != LANES * BENCH_ROUNDS
                or not math.isfinite(r["value"]) or r["value"] <= 0):
            raise AssertionError(f"bench with bf16 stats: {json.dumps(r)}")
        # measure resets the counts before each generation: these are the
        # last timed one's
        expect_bf16(K, "the bench's last timed generation")
        launches = dict(launch_counts(K), select=phase_launches["select"])
        print(f"bench with bf16 stats: {r['value']} env-steps/s, "
              f"{time.perf_counter() - t0:.3f} s with the warm-up; spread "
              f"{ex['spread']:.4f}; illegal moves 0  [{card}]")

        games, rollouts, moves = BF16_DUEL
        duel_cfg = DuelConfig(num_games=games, rollouts=rollouts,
                              max_moves=moves)
        gen = torch.Generator(device=dev).manual_seed(SEED + 17)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        first, draws, second, unfinished = (
            int(x) for x in duel_half(game, net, net, gen, duel_cfg, dev))
        wall = time.perf_counter() - t0
        expect_launches(K, "the bf16 duel half",
                        {"select_apply": moves * rollouts, "backup": moves,
                         **rules(game, moves * (rollouts + 1))})
        expect_bf16(K, "the bf16 duel half")
        if first + draws + second + unfinished != games:
            raise AssertionError("bf16 duel half: games lost")
        print(f"duel half with bf16 stats: connect4, {games} lanes, "
              f"{rollouts} rollouts, {moves} moves: first/draws/second/"
              f"unfinished {first}/{draws}/{second}/{unfinished}, "
              f"{wall:.3f} s  [{card}]")

        probe = probe_for_game(game, BF16_PROBE[1])
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        w, d, l, trace = eval_vs_probe(
            game, net, gen, probe, num_games=BF16_PROBE[0],
            rollouts=ROLLOUTS, cpuct=CPUCT, seed=SEED, trace=True,
            device=dev)
        wall = time.perf_counter() - t0
        plies = len(trace["records"])
        expect_launches(K, f"eval_vs_probe with bf16 stats ({plies} plies)",
                        {"select_apply": plies * ROLLOUTS, "backup": plies,
                         **rules(game, plies * (ROLLOUTS + 1))})
        expect_bf16(K, "eval_vs_probe with bf16 stats")
        if w + d + l != BF16_PROBE[0]:
            raise AssertionError(f"eval_vs_probe, bf16 stats: {w}/{d}/{l}")
        print(f"eval_vs_probe with bf16 stats: connect4 vs LineProbe depth "
              f"{probe.depth}, {BF16_PROBE[0]} games x {ROLLOUTS} rollouts: "
              f"net W/D/L {w}/{d}/{l}, {plies} plies, {wall:.3f} s  [{card}]")
    finally:
        if saved is None:
            os.environ.pop("ALPHATPU_BF16_STATS", None)
        else:
            os.environ["ALPHATPU_BF16_STATS"] = saved
    print(f"bf16 stat storage: {time.perf_counter() - t_phase:.3f} s  "
          f"[{card}]")
    return launches


def captured_rounds(K, dev, card: str) -> None:
    """Phase 17: one move round as one program.  An eager round of
    continuous selfplay (connect4 4x512, LANES lanes) under
    ``torch.cuda.set_sync_debug_mode("error")``; then, for each of
    CAPTURE_RUNS, CAPTURE_ROUNDS continuous rounds eagerly and from a
    CUDA graph (its first round eager, the second captured, every later
    one a replay) from the same generator: buffer rows, stats, carry
    (root policies included) and the generator's state bit for bit, each
    run's launches as owed; the call's tail (back-fill, buffer write, next
    carry, stats) runs eagerly and is captured in the first call; at
    level 1 a second captured call (rounds and tail replayed) and a
    second eager one, the first call's carry unchanged by the second, and
    a third captured call under ``set_sync_debug_mode('error')``.  Then a
    CAPTURE_DUEL duel half, both nets' rounds captured, against its eager
    rounds bit for bit; generation-mode selfplay (:func:`captured_generation`)
    and every ablation variant (:func:`captured_ablation`).  Prints
    env-steps/s, capture seconds, graph nodes, graph-pool bytes and peak
    device memory."""
    import torch

    from alphatpu_torch import graphs
    from alphatpu_torch.buffer import create_buffer
    from alphatpu_torch.duel import DuelConfig, duel_half
    from alphatpu_torch.games import make_game
    from alphatpu_torch.nets import MLP, config_for_game
    from alphatpu_torch.selfplay import (
        ContinuousRounds, SelfplayConfig, make_carry, selfplay_continuous,
    )

    t_phase = time.perf_counter()
    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game), SEED, device=dev)
    T, G = CAPTURE_ROUNDS, LANES
    cfg = SelfplayConfig(num_games=G, rollouts=ROLLOUTS, cpuct=CPUCT,
                         rounds=T)
    graphs.clear_cache()

    # an eager round: nothing in it may wait for the device.  The first
    # round of a game object copies its constants to the card (once, as
    # a captured program's eager first round does); the second is checked
    st = ContinuousRounds(game, cfg, T, dev)
    st.start(make_carry(game, G, None, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    graphs.play(st, 1, lambda t: net, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphs.play(st, 1, lambda t: net, gen)
        queued = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"eager round under set_sync_debug_mode('error'): connect4, {G} "
          f"lanes, {ROLLOUTS} rollouts, the second round of a call: queued "
          f"in {queued:.3f} s, done in {time.perf_counter() - t0:.3f} s, no "
          f"call waited  [{card}]")
    del st

    # a buffer for each mode, emptied before each call: the captured tail
    # writes its buffer by address, so one buffer keeps one tail graph
    bufs = {c: create_buffer(game, G * T, device=dev) for c in (True, False)}

    def run(captured, carry, label, kernel, strict=False):
        """One call of T rounds (``strict``: under
        ``set_sync_debug_mode('error')``); returns (tensors, carry, wall,
        stats, graph counts)."""
        buf = bufs[captured]
        for x in vars(buf).values():
            x.zero_()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        graphs.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if strict else 0)
        try:
            _, stats, carry = selfplay_continuous(game, net, buf, None, cfg,
                                                  carry, captured=captured)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_launches(K, f"{T} {'captured' if captured else 'eager'} "
                        f"rounds, {label}",
                        {kernel: T * ROLLOUTS, "backup": T,
                         **rules(game, T * (ROLLOUTS + 1))})
        counts = dict(graphs.counts,
                      peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
        out = [getattr(buf, f) for f in ("state", "policy", "player",
                                         "value", "fstate", "cursor",
                                         "total")]
        out = [x.clone() for x in out]
        out += [stats[k] for k in sorted(stats)]
        out += [carry.count, carry.enc, carry.pol, carry.player,
                *carry.positions, carry.rng.get_state()]
        return out, carry, wall, stats, counts

    def fresh_carry():
        return make_carry(
            game, G, torch.Generator(device=dev).manual_seed(SEED + 29), dev)

    def rate(stats, wall):
        return float(stats["samples_written"] + stats["carried"]) / wall

    for label, env, kernel in CAPTURE_RUNS:
        with switches(env):
            eager, eager_carry, e_wall, e_stats, _ = run(
                False, fresh_carry(), label, kernel)
            cap, cap_carry, c_wall, c_stats, counts = run(
                True, fresh_carry(), label, kernel)
            bad = [i for i, (x, y) in enumerate(zip(cap, eager))
                   if x.dtype != y.dtype or not torch.equal(x, y)]
            if bad or len(cap) != len(eager):
                raise AssertionError(f"captured rounds, {label}: tensors "
                                     f"{bad} differ from the eager rounds")
            # round 0 eager, then captured; the tail eager, then captured
            if (counts["captures"], counts["replays"]) != (2, T - 1) or int(
                    c_stats["illegal_moves"]):
                raise AssertionError(f"captured rounds, {label}: {counts}")
            print(f"captured rounds, {label}: connect4 4x512, {G} lanes, "
                  f"{ROLLOUTS} rollouts, {T} rounds: buffer rows, stats, "
                  f"carry and generator state equal to the eager rounds' "
                  f"bit for bit; eager {rate(e_stats, e_wall):.1f} "
                  f"env-steps/s ({e_wall:.3f} s), captured "
                  f"{rate(c_stats, c_wall):.1f} env-steps/s ({c_wall:.3f} s:"
                  f" round 0 and the tail eager, then captured in "
                  f"{counts['capture_s']:.3f} s, "
                  f"{counts['replays']} replays); graph nodes "
                  f"{counts['capture_nodes']}, graph pool "
                  f"{counts['capture_pool_bytes']} B, peak_mem_bytes "
                  f"{counts['peak_mem_bytes']}  [{card}]")
            if label != "level 1":
                continue
            # the same calls again: replays only (the older carry stays
            # the caller's), then eager, then captured under
            # set_sync_debug_mode('error')
            held = [x.clone() for x in (cap_carry.count, cap_carry.enc,
                                        cap_carry.pol, cap_carry.player,
                                        *cap_carry.positions)]
            cap2, cap2_carry, c2_wall, c2_stats, counts2 = run(
                True, cap_carry, label, kernel)
            eager2, eager2_carry, e2_wall, e2_stats, _ = run(
                False, eager_carry, label, kernel)
            if counts2["replays"] != T + 1 or counts2["captures"] or any(
                    not torch.equal(x, y) for x, y in zip(cap2, eager2)):
                raise AssertionError(f"the second captured call, {label}: "
                                     f"{counts2}")
            if any(not torch.equal(a, b) for a, b in zip(held, (
                    cap_carry.count, cap_carry.enc, cap_carry.pol,
                    cap_carry.player, *cap_carry.positions))):
                raise AssertionError("a captured call overwrote the carry "
                                     "an earlier call returned")
            cap3, _, c3_wall, _, counts3 = run(True, cap2_carry, label,
                                               kernel, strict=True)
            eager3, *_ = run(False, eager2_carry, label, kernel)
            if counts3["replays"] != T + 1 or any(
                    not torch.equal(x, y) for x, y in zip(cap3, eager3)):
                raise AssertionError(f"the third captured call, {label}: "
                                     f"{counts3}")
            print(f"captured rounds, {label}, a second call of {T} rounds "
                  f"(every round and the tail a replay): captured "
                  f"{rate(c2_stats, c2_wall):.1f} env-steps/s "
                  f"({c2_wall:.3f} s), eager {rate(e2_stats, e2_wall):.1f} "
                  f"env-steps/s ({e2_wall:.3f} s), equal bit for bit; "
                  f"peak_mem_bytes {counts2['peak_mem_bytes']}; the first "
                  f"call's carry unchanged; a third captured call under "
                  f"set_sync_debug_mode('error'): no host sync, "
                  f"{c3_wall:.3f} s, equal to the eager one  [{card}]")
    graphs.clear_cache()

    # a duel half: a graph per net, shared by the program's rounds
    games, rollouts = CAPTURE_DUEL
    duel = DuelConfig(num_games=games, rollouts=rollouts)
    other = MLP.from_seed(config_for_game(game), SEED + 1, device=dev)
    Td = game.max_game_length
    outs = {}
    for captured in (False, True):
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        graphs.reset_counts()
        t0 = time.perf_counter()
        tally = duel_half(game, net, other, gen, duel, dev,
                          captured=captured)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_launches(K, f"the {'captured' if captured else 'eager'} duel "
                        f"half", {"select_apply_packed": Td * rollouts,
                                  "backup": Td,
                                  **rules(game, Td * (rollouts + 1))})
        outs[captured] = ([*tally, gen.get_state()], wall,
                          dict(graphs.counts))
    (cap, c_wall, counts), (eager, e_wall, _) = outs[True], outs[False]
    if any(not torch.equal(x, y) for x, y in zip(cap, eager)) or (
            counts["captures"], counts["replays"]) != (2, Td - 2):
        raise AssertionError(f"captured duel half != eager: {cap} {eager} "
                             f"{counts}")
    print(f"captured duel half: connect4 4x512, {games} lanes, {rollouts} "
          f"rollouts, {Td} rounds: first/draws/second/unfinished "
          f"{'/'.join(str(int(x)) for x in cap[:4])} and the generator's "
          f"state equal to the eager rounds'; eager {e_wall:.3f} s, "
          f"captured {c_wall:.3f} s (two captures, "
          f"{counts['capture_s']:.3f} s, {counts['replays']} replays)  "
          f"[{card}]")
    graphs.clear_cache()

    # the tail's device time, replayed and eager, after T captured rounds
    st = ContinuousRounds(game, cfg, T, dev)
    st.start(fresh_carry())
    graphs.play(st, T, lambda t: net, None, captured=True)
    buf = bufs[True]

    def tail_ms(fn, reps=5):
        out = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return out

    graphs.step(st, "tail", partial(st.tail, buf), True)  # eager, captured
    replayed = tail_ms(lambda: graphs.step(st, "tail", partial(st.tail, buf),
                                           True))
    eager = tail_ms(lambda: st.tail(buf))
    print(f"the call's tail ({G} lanes, {T} rounds: back-fill, buffer write, "
          f"next carry, stats): device ms a replay "
          f"{', '.join(f'{x:.3f}' for x in replayed)}; eager "
          f"{', '.join(f'{x:.3f}' for x in eager)}  [{card}]")
    del st
    graphs.clear_cache()
    captured_generation(K, dev, card)
    captured_ablation(K, dev, card)
    print(f"captured rounds: {time.perf_counter() - t_phase:.3f} s  "
          f"[{card}]")


def captured_generation(K, dev, card: str) -> None:
    """Phase 17: selfplay_generation (tictactoe 6x128, CAPTURE_GENERATION
    lanes, ROLLOUTS rollouts, whole games) in two chained calls, captured
    (the second replays its rounds and its tail, under
    ``set_sync_debug_mode('error')``) and eager: buffer and stats bit for
    bit."""
    import torch

    from alphatpu_torch import graphs
    from alphatpu_torch.buffer import create_buffer
    from alphatpu_torch.games import make_game
    from alphatpu_torch.nets import MLP, config_for_game
    from alphatpu_torch.selfplay import SelfplayConfig, selfplay_generation

    game = make_game("tictactoe")
    net = MLP.from_seed(config_for_game(game), SEED, device=dev)
    G, T = CAPTURE_GENERATION, game.max_game_length
    cfg = SelfplayConfig(num_games=G, rollouts=ROLLOUTS, cpuct=CPUCT)
    outs = {}
    for captured in (True, False):
        graphs.clear_cache()
        graphs.reset_counts()
        buf = create_buffer(game, 4 * G * T, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 37)
        K.reset_launch_counts()
        out, walls = [], []
        for call in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error" if captured and call
                                           else 0)
            try:
                _, stats = selfplay_generation(game, net, buf, gen, cfg,
                                               captured=captured)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            out += [stats[k] for k in sorted(stats)]
        expect_launches(K, f"two {'captured' if captured else 'eager'} "
                        "generations (tictactoe)",
                        {"select_apply_packed": 2 * T * ROLLOUTS,
                         "backup": 2 * T,
                         **rules(game, 2 * T * (ROLLOUTS + 1))})
        out += [*(getattr(buf, f) for f in ("state", "policy", "player",
                                            "value", "fstate", "cursor",
                                            "total")), gen.get_state()]
        outs[captured] = (out, walls, dict(graphs.counts))
    (cap, c_walls, counts), (eager, e_walls, _) = outs[True], outs[False]
    if any(x.dtype != y.dtype or not torch.equal(x, y)
           for x, y in zip(cap, eager)) or (
            counts["captures"], counts["replays"]) != (2, 2 * T):
        raise AssertionError(f"captured generation != eager: {counts}")
    print(f"captured generation: tictactoe 6x128, {G} games x {ROLLOUTS} "
          f"rollouts, {T} rounds, two calls: buffer, stats and generator "
          f"state equal to the eager calls' bit for bit; the second "
          f"captured call (rounds and tail replayed) under "
          f"set_sync_debug_mode('error'): no host sync; captured "
          f"{c_walls[0]:.3f} s then {c_walls[1]:.3f} s, eager "
          f"{e_walls[0]:.3f} s then {e_walls[1]:.3f} s  [{card}]")
    graphs.clear_cache()


def captured_ablation(K, dev, card: str) -> None:
    """Phase 17: every ablation variant's move (connect4, CAPTURE_ABLATE
    lanes, ROLLOUTS rollouts; a warm-up and two timed moves) replayed from
    a CUDA graph and run eagerly from the same generator state: the tree
    planes, the generator's state and the launches owed, bit for bit."""
    import torch

    from alphatpu_torch.benchmarks import ablate_rollout
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game

    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game), SEED, device=dev)
    positions = game.initial(CAPTURE_ABLATE, dev)
    line = []
    for name, variant in ablate_rollout.VARIANTS.items():
        outs, ms = [], []
        for captured in (True, False):
            tree = init_tree(game, positions, ROLLOUTS)
            gen = torch.Generator(device=dev).manual_seed(SEED + 41)
            t, counted = ablate_rollout.time_variant(
                game, net, tree, positions, gen, ROLLOUTS, variant, 2,
                captured=captured)
            ms.append(t)
            outs.append([tree.prior, tree.wsum, tree.visits, tree.parent,
                         tree.action_from, tree.expanded, tree.next_idx,
                         *tree.states, gen.get_state()])
        if any(not torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"captured ablation {name} != eager")
        line.append(f"{name} {ms[0]:.2f}/{ms[1]:.2f}")
    print(f"captured ablation: connect4 4x512, {CAPTURE_ABLATE} lanes, "
          f"{ROLLOUTS} rollouts, each variant's tree planes and generator "
          f"state equal to the eager moves' bit for bit, launches as owed; "
          f"ms a move captured/eager: {', '.join(line)}  [{card}]")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "NVIDIA GPU.")
    ap.add_argument("--rules", action="store_true",
                    help="phases 1-2 and phase 3's rules parity alone")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this smoke needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    # ---- 1. the card ----
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)  # the nvidia-smi line as it stands: name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {kind}, devices: {torch.cuda.device_count()}")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # the level-1 phases run the default engine; selfplay_run sets the
    # switches of the other two
    for k in ("ALPHATPU_PACK", "ALPHATPU_NO_PACK"):
        os.environ.pop(k, None)

    from alphatpu_torch import _build

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    for line in ptxas_lines(_build.build_report["log"]):
        print(f"  ptxas: {line}")
    for line in sass_counts(_build.library_path()):
        print(f"  sass: {line}")

    if args.rules:
        print(json.dumps({"rules": {
            name: {"shape": r["shape"], "ms": r["ms"],
                   "plain_ms": r["plain_ms"], "bound_ms": r["cost"].bound_ms,
                   "bound_by": r["cost"].bound_by, "max_abs_err": r["err"],
                   "launch_floor_ms": r["launch_floor_ms"],
                   "ms_by_game": r["ms_by_game"],
                   "plain_ms_by_game": r["plain_ms_by_game"]}
            for name, r in rules_parity(dev, card).items()}}))
        return 0
    return smoke(dev, card, kind)


def demangle(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name."""
    import re

    # _ZN <length><identifier>... [I<template arguments>E]: the last
    # identifier is the function, after its (possibly hashed)
    # namespaces; the arguments are ints (Li<n>E: lanes, slots), the
    # packed kernels' column view (N4walk<length><view>E), the
    # three-plane kernels' storage type (f, or <length>__nv_bfloat16)
    # and reversi_play's action type (i or l)
    rest, ident = re.sub(r"^_ZN?", "", mangled), mangled
    while (n := re.match(r"\d+", rest)):
        size = int(n.group())
        ident = rest[len(n.group()):len(n.group()) + size]
        rest = rest[len(n.group()) + size:]
    if not rest.startswith("I"):
        return ident
    rest, args = rest[1:], []
    while True:
        if (m := re.match(r"Li(\d+)E", rest)):
            args.append(m.group(1))
        elif (m := re.match(r"N4walk(\d+)", rest)):
            end = m.end() + int(m.group(1))
            args.append(rest[m.end():end])
            m = re.match(r".{%d}E" % end, rest)
        elif (m := re.match(r"f", rest)):
            args.append("float")
        elif (m := re.match(r"[il]", rest)):  # the rules' action type
            args.append({"i": "int32_t", "l": "int64_t"}[m.group()])
        elif (m := re.match(r"(\d+)", rest)):
            end = m.end() + int(m.group(1))
            args.append(rest[m.end():end])
            m = re.match(r".{%d}" % end, rest)
        else:
            break
        rest = rest[m.end():]
    return f"{ident}<{', '.join(args)}>" if args else ident


def sass_counts(library) -> list:
    """The SASS instruction count of each rules kernel instantiation in
    the built ``library`` (``cuobjdump -sass``, one line an instruction,
    the padding after the last included) and its branches (``BRA``, the
    trap loop after the last ``EXIT`` included); empty where the toolkit
    has no ``cuobjdump``."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return []
    dump = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, branches, name = {}, {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = demangle(m.group(1))
            kernel = name.split("<")[0].removesuffix("_kernel")
            name = name if kernel in RULES else None
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] = counts.get(name, 0) + 1
            branches[name] = branches.get(name, 0) + bool(
                re.search(r"\bBRA\b", line))
    return [f"{k}: {n} instructions, {branches[k]} BRA"
            for k, n in sorted(counts.items())]


def ptxas_lines(log: str) -> list:
    """One line per kernel instantiation from ptxas's ``-v`` report: the
    kernel and its <lanes, slots> (read off the mangled name), registers,
    stack frame and spills."""
    import re

    lines, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = demangle(m.group(1))
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{name}: {regs} registers, {frame}")
            name, frame = None, ""
    return lines


def smoke(dev, card: str, kind: str) -> int:
    """Phases 3-18 on the device ``dev``; ``card`` is the nvidia-smi line
    printed beside every time, ``kind`` the device name."""
    import torch

    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game

    # each phase's wall, printed with the result
    walls, t_lap = {}, [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        walls[phase] = round(now - t_lap[0], 3)
        t_lap[0] = now

    # ---- 3. kernel parity ----
    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game), SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A, V, G = game.max_actions, ROLLOUTS, LANES
    scale = K.value_scale(ROLLOUTS)

    tree = init_tree(game, game.initial(G, dev), V)
    run_mcts(game, net, tree, rollouts=V - 2, cpuct=CPUCT, training=True,
             generator=gen)
    D = min(game.max_game_length, V)
    results = parity(K, tree, D, gen, CPUCT, scale,
                     f"connect4 A={A} V={V} G={G} D={D}", True)
    print(f"  [{card}]")
    walk_breakdown(K, tree, D, gen, scale, card)

    Aw, Vw, Gw = WIDE
    wide = synthetic_tree_on(dev, Aw, Vw, Gw, scale, SEED + 1)
    wide_results = parity(K, wide, min(Aw, Vw), gen, CPUCT, scale,
                          f"synthetic A={Aw} V={Vw} G={Gw}", True)
    print(f"  [{card}]")
    errs = {k: max(results[k]["err"], wide_results[k]["err"])
            for k in KERNELS}
    del wide

    # a tree whose columns do not fit a block: the four walks read them
    # from device memory (its own generator: the later phases draw as
    # before)
    Ad, Vd, Gd = DEVICE_SHAPE
    geo = K.walk_geometry(Ad, Gd, Vd)
    if geo.placement != K.DEVICE_COLUMNS:
        raise AssertionError(f"A={Ad} V={Vd} G={Gd}: geometry {geo}")
    big = synthetic_tree_on(dev, Ad, Vd, Gd, scale, SEED + 2)
    Dd = min(game.max_game_length, Vd)
    device_results = parity(
        K, big, Dd, torch.Generator(device=dev).manual_seed(SEED + 2), CPUCT,
        scale, f"synthetic A={Ad} V={Vd} G={Gd} D={Dd}, columns in device "
        f"memory ({geo.threads} threads x {geo.blocks} blocks)", True,
        kernels=WALKS)
    print(f"  [{card}]")
    for k, r in device_results.items():
        errs[k] = max(errs[k], r["err"])

    # the bf16 instantiations of the three-plane kernels, at the same
    # three shapes: a connect4 tree grown on bf16 planes (by the level-0
    # engine on them), and the two synthetic trees rounded to bf16 (their
    # own generators: the later phases draw as before)
    bf16 = torch.bfloat16
    gen16 = torch.Generator(device=dev).manual_seed(SEED + 3)
    tree16 = init_tree(game, game.initial(G, dev), V, stat_dtype=bf16)
    run_mcts(game, net, tree16, rollouts=V - 2, cpuct=CPUCT, training=True,
             generator=gen16)
    bf16_results = parity(K, tree16, D, gen16, CPUCT, scale,
                          f"bf16 planes, connect4 A={A} V={V} G={G} D={D}",
                          True, kernels=BF16_KERNELS)
    del tree16
    wide = as_bf16(synthetic_tree_on(dev, Aw, Vw, Gw, scale, SEED + 1))
    bf16_wide = parity(K, wide, min(Aw, Vw), gen16, CPUCT, scale,
                       f"bf16 planes, synthetic A={Aw} V={Vw} G={Gw}", True,
                       kernels=BF16_KERNELS)
    del wide
    big = as_bf16(big)
    bf16_device = parity(
        K, big, Dd, torch.Generator(device=dev).manual_seed(SEED + 2), CPUCT,
        scale, f"bf16 planes, synthetic A={Ad} V={Vd} G={Gd} D={Dd}, "
        "columns in device memory", True, kernels=("select_apply", "select"))
    print(f"  [{card}]")
    bf16_errs = {k: max(r[k]["err"] for r in (bf16_results, bf16_wide,
                                               bf16_device) if k in r)
                 for k in BF16_KERNELS}
    del big

    # the game rules' kernels
    rules_results = rules_parity(dev, card)

    lap("3. kernel parity")

    # ---- 4. the search on the card against the CPU path ----
    net_cpu = MLP.from_seed(config_for_game(game), SEED,
                            device=torch.device("cpu"))
    for level in (1, 2, 0):
        search_vs_cpu(game, net, net_cpu, dev, V, SMALL_G, level)

    lap("4. the search on the card against the CPU path")

    # ---- 5. a pre-grown search at full width ----
    half = ROLLOUTS // 2
    tree = init_tree(game, game.initial(G, dev), V)
    K.reset_launch_counts()
    run_mcts(game, net, tree, rollouts=half, cpuct=CPUCT, training=True,
             generator=gen)
    _, pi = run_mcts(game, net, tree, rollouts=half, cpuct=CPUCT,
                     training=True, generator=gen, segment_rollouts=False)
    torch.cuda.synchronize()
    expect_launches(K, "the pre-grown search",
                    {"select_apply_packed": half, "select_apply": half,
                     "backup": 2, **rules(game, 2 * half)})
    root_total = tree.visits[:, 0, :].sum(0)
    if not bool((root_total == 2 * half - 1).all()):
        raise AssertionError("pre-grown search: root visits != rollouts - 1")
    if not bool(torch.isfinite(pi).all()) or not bool(
            (tree.wsum <= tree.visits).all()):
        raise AssertionError("pre-grown search: bad stats")
    print(f"pre-grown search: {G} lanes, {half} level-1 rollouts then {half}"
          f" f32 rollouts; mean nodes allocated "
          f"{float(tree.next_idx.float().mean()):.2f} of {V}")
    del tree
    big_tree_searches(K, game, net, net_cpu, dev, card)

    lap("5. a pre-grown search at full width")

    # ---- 6. the per-phase search at full width ----
    probs = torch.rand((V, D, G), generator=gen, device=dev)
    tree = init_tree(game, game.initial(G, dev), V)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    pi = phase_search(game, net, tree, probs, CPUCT)
    torch.cuda.synchronize()
    phase_wall = time.perf_counter() - t0
    phase_launches = expect_launches(K, "the per-phase search",
                                     {"select": V, "backup": V,
                                      **rules(game, V)})
    ref = init_tree(game, game.initial(G, dev), V)
    _, ref_pi = run_mcts(game, net, ref, rollouts=V, cpuct=CPUCT,
                         training=True, probs=probs, packed_stats=False)
    fields = ("parent", "action_from", "expanded", "next_idx", "prior",
              "wsum", "visits")
    bad = diverged_lanes(tuple(getattr(tree, f) for f in fields) + (pi,),
                         tuple(getattr(ref, f) for f in fields) + (ref_pi,))
    print(f"per-phase search (select, expand, backup): {G} lanes, {V} "
          f"rollouts in {phase_wall:.3f} s; lanes that differ from the f32 "
          f"engine's run_mcts: {int(bad.sum())}/{G}")
    if int(bad.sum()) != 0:
        raise AssertionError("per-phase search != the f32 engine")
    del tree, ref, probs

    lap("6. the per-phase search at full width")

    # ---- 7. the main paths: continuous selfplay ----
    launches = {}
    rates = {}
    for label, env, chunks, kernel in (
            ("level 1", {}, CHUNKS, "select_apply_packed"),
            ("level 2 (ALPHATPU_PACK=2)", {"ALPHATPU_PACK": "2"}, 1,
             "select_apply_packed1"),
            ("level 0 (ALPHATPU_NO_PACK=1)", {"ALPHATPU_NO_PACK": "1"}, 1,
             "select_apply")):
        got, rates[label] = selfplay_run(K, game, net, dev, label, env,
                                         chunks, kernel, card)
        launches[kernel] = got[kernel]
    launches["select"] = phase_launches["select"]
    print("env-steps/s in this run: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()) + f"  [{card}]")
    del net, net_cpu
    torch.cuda.empty_cache()

    lap("7. the main paths: continuous selfplay")

    # ---- 8. every other family at full width ----
    family_launches = family_runs(K, dev, card)

    lap("8. every other family at full width")

    # ---- 9. the path's shapes: card against CPU, kernels against plain ----
    for k, e in path_shapes(K, dev, gen, PATH_SHAPES).items():
        errs[k] = max(errs[k], e)
    for k, e in deep_trees(K, dev, torch.Generator(device=dev).manual_seed(
            SEED + 4), card).items():
        errs[k] = max(errs[k], e)

    lap("9. the path's shapes: card against CPU, kernels against plain")

    # ---- 10. one generation of the training pipeline ----
    t_phase = time.perf_counter()
    for name, lanes in GEN_GAMES:
        pipeline_generation(K, dev, card, name, lanes)
        torch.cuda.empty_cache()
    print(f"pipeline generations ({', '.join(g for g, _ in GEN_GAMES)}): "
          f"{time.perf_counter() - t_phase:.3f} s  [{card}]")

    lap("10. one generation of the training pipeline")

    # ---- 11. the CLI: the main path ----
    cli = cli_run(K, dev, card)
    launches["select_apply_packed"] = cli["select_apply_packed"]
    launches["backup"] = cli["backup"]
    # the rules kernels: reversi's from phase 8's reversi8x8 selfplay (the
    # record's training path), hex_is_over from its hex13 selfplay,
    # line_is_over from the CLI's tictactoe
    launches["line_is_over"] = cli["line_is_over"]
    for name in ("reversi_play", "reversi_is_over"):
        launches[name] = family_launches["reversi8x8"][name]
    launches["hex_is_over"] = family_launches["hex13"]["hex_is_over"]
    launches["select_apply_packed1"] = cli_level2(
        K, dev, card)["select_apply_packed1"]

    lap("11. the CLI: the main path")

    # ---- 12. evaluation and play ----
    for k, e in evaluation_and_play(K, dev, card).items():
        errs[k] = max(errs[k], e)

    lap("12. evaluation and play")

    # ---- 13. data parallel on one card ----
    data_parallel(K, dev, card)
    torch.cuda.empty_cache()

    lap("13. data parallel on one card")

    # ---- 14. the net zoo ----
    zoo_searches(K, dev, card)
    torch.cuda.empty_cache()

    lap("14. the net zoo")

    # ---- 15. the bench and the rollout ablation ----
    bench_runs(card)

    lap("15. the bench and the rollout ablation")

    # ---- 16. the bf16 stat storage end to end ----
    bf16_launches = bf16_stats_path(K, dev, card)

    lap("16. the bf16 stat storage end to end")

    # ---- 17. captured rounds against eager rounds ----
    captured_rounds(K, dev, card)

    lap("17. captured rounds against eager rounds")

    # ---- 18. result ----
    def row(name, src, line, count, err, r, w, d):
        return {"name": name, "route": "cuda", "source": CSRC + src,
                "replaces": PALLAS + line, "launches": count,
                "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["cost"].bound_ms,
                "bound_by": r["cost"].bound_by,
                "library_ms": r["library_ms"], "ms_wide": w["ms"],
                "plain_ms_wide": w["plain_ms"],
                "bound_ms_wide": w["cost"].bound_ms,
                "library_ms_wide": w["library_ms"],
                "ms_device": d and d["ms"],
                "bound_ms_device": d and d["cost"].bound_ms}

    rows = [row(name, src, line, launches[name], errs[name], results[name],
                wide_results[name], device_results.get(name))
            for name, (src, line) in KERNELS.items()]
    # the bf16 instantiations: launches of phase 16's bench generation
    # (select_apply, backup) and of its per-phase search (select)
    rows += [row(name + "_bf16", *KERNELS[name], bf16_launches[name],
                 bf16_errs[name], bf16_results[name], bf16_wide[name],
                 bf16_device.get(name))
             for name in BF16_KERNELS]
    # the rules kernels: each replaces no Pallas kernel (the reference's
    # rule is a loop of jnp ops that XLA fuses)
    rows += [{"name": name, "route": "cuda", "source": CSRC + "rules.cu",
              "replaces": ref, "replaces_pallas": None,
              "launches": launches[name],
              "max_abs_err": rules_results[name]["err"],
              "ms": rules_results[name]["ms"],
              "plain_ms": rules_results[name]["plain_ms"],
              "bound_ms": rules_results[name]["cost"].bound_ms,
              "bound_by": rules_results[name]["cost"].bound_by,
              "library_ms": None, "shape": rules_results[name]["shape"],
              "launch_floor_ms": rules_results[name]["launch_floor_ms"],
              "over_floor_ms": rules_results[name]["ms"]
              - rules_results[name]["launch_floor_ms"],
              "ms_by_game": rules_results[name]["ms_by_game"],
              "plain_ms_by_game": rules_results[name]["plain_ms_by_game"]}
             for name, ref in RULES.items()]
    lap("18. result")
    print(f"phase walls (s): {json.dumps(walls)}  [{card}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
