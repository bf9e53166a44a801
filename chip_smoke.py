#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``alphatpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions; no CUDA device -> exit 1,
2. build the CUDA kernels from ``alphatpu_torch/csrc`` (nvcc, sm_90a),
3. kernel parity on the card: each kernel against its plain torch version
   on the same inputs - at the production shape (connect4, A=7, V=64,
   G=8192, D=42, on a tree grown by the port's own search) and at a
   synthetic wide shape (A=169, V=64, G=2048) - and each kernel's time
   against its plain version's at the production shape,
4. the search on the card against the port's CPU path on a small input,
5. the main path: continuous selfplay on connect4 with the 4x512 net from a
   fixed seed, 8192 lanes, 64 rollouts per move, 48 rounds chained through
   the episode carry, with every kernel's launch count checked,
6. a JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``.

Kernel parity: the packed and prior planes must be exactly equal; paths,
leaves and needs_alloc exactly equal outside the CDF-tie class (a lane
whose sampled uniform lands on a prefix-sum tie may take another action),
at most max(2, G // 500) lanes; the root policy to rtol 1e-5; the backup's
visits exactly and its wsum to rtol 1e-6.
"""
import json
import subprocess
import sys
import time

SEED = 0
CPUCT = 1.5
LANES = 8192
ROLLOUTS = 64
CHUNK_ROUNDS = 24
CHUNKS = 2  # 48 rounds
SELECT_SOURCE = "alphatpu_torch/csrc/select_apply_packed.cu"
BACKUP_SOURCE = "alphatpu_torch/csrc/backup.cu"


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


def compare_select(K, inputs, pend, probs, cpuct, scale):
    """One select_apply_packed call through the kernel and one through the
    plain version, each on its own copy of the mutable planes.  Returns
    (n diverged lanes, max abs error, kernel Selection)."""
    import torch

    prior, packed, parent, action_from, expanded = inputs
    pk, ppk = prior.clone(), packed.clone()
    pp, ppp = prior.clone(), packed.clone()
    sk = K.select_apply_packed(pk, ppk, parent, action_from, expanded, probs,
                               pend, cpuct, scale)
    sp = K.select_apply_packed_plain(pp, ppp, parent, action_from, expanded,
                                     probs, pend, cpuct, scale)
    torch.cuda.synchronize()
    if not torch.equal(pk, pp) or not torch.equal(ppk, ppp):
        raise AssertionError("select_apply_packed: the updated planes differ")
    bad = diverged_lanes(
        (sk.nodes, sk.actions, sk.leaf, sk.leaf_action, sk.needs_alloc),
        (sp.nodes, sp.actions, sp.leaf, sp.leaf_action, sp.needs_alloc))
    n = int(bad.sum())
    if n > tie_limit(bad.numel()):
        raise AssertionError(f"select_apply_packed: {n} diverged lanes")
    torch.testing.assert_close(sk.root_pi, sp.root_pi, rtol=1e-5, atol=1e-6)
    err = float((sk.root_pi - sp.root_pi).abs().max())
    return n, err, sk


def pending_from(K, sel, next_idx, A, scale, gen):
    """A realistic pending update: the walk of ``sel``, a random leaf value
    on the 1/scale grid, a random normalized prior row at the leaf."""
    import torch

    G = sel.leaf.shape[0]
    dev = sel.leaf.device
    newp = torch.rand((A, G), generator=gen, device=dev)
    return K.PendingUpdate(
        nodes=sel.nodes, actions=sel.actions,
        length=(sel.nodes >= 0).sum(0, dtype=torch.int32),
        value=K.quantize_value(torch.rand((G,), generator=gen, device=dev),
                               scale),
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
    1/scale grid."""
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
    for v in range(1, n):
        parent[v] = rng.integers(0, v, G)
        action_from[v] = perm[v]
        expanded[parent[v], gi] = True
        legal[perm[v], parent[v], gi] = True
    legal &= expanded[None]
    prior = np.where(legal, rng.random((A, V, G)), 0.0)
    # as in a grown tree, only edges with a child have visits, and they
    # hold most of their node's mass (so that walks go deep)
    child = np.zeros((A, V, G), bool)
    for v in range(1, n):
        child[action_from[v], parent[v], gi] = True
    prior = np.where(child, prior + 20.0, prior)
    prior = (prior / np.maximum(prior.sum(0, keepdims=True), 1e-30))
    visits = np.where(child, rng.integers(1, 5, (A, V, G)), 0)
    wsum = np.floor(rng.random((A, V, G)) * visits * scale) / scale
    return (prior.astype(np.float32), wsum.astype(np.float32),
            visits.astype(np.float32), parent, action_from, expanded,
            np.full((G,), n, np.int32))


def main() -> int:
    import torch

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

    from alphatpu_torch import _build
    from alphatpu_torch.buffer import buffer_size, create_buffer
    from alphatpu_torch.games import make_game
    from alphatpu_torch.mcts import kernels as K
    from alphatpu_torch.mcts.search import run_mcts
    from alphatpu_torch.mcts.tree import init_tree
    from alphatpu_torch.nets import MLP, config_for_game
    from alphatpu_torch.selfplay import (
        SelfplayConfig, make_carry, selfplay_continuous,
    )

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    for line in _build.build_report["log"].splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel parity ----
    game = make_game("connect4")
    net = MLP.from_seed(config_for_game(game), SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A, V, G = game.max_actions, ROLLOUTS, LANES
    D = min(game.max_game_length, V)
    scale = K.value_scale(ROLLOUTS)

    tree = init_tree(game, game.initial(G, dev), V)
    run_mcts(game, net, tree, rollouts=V - 2, cpuct=CPUCT, training=True,
             generator=gen)
    packed = K.pack_stats(tree.wsum, tree.visits, scale)
    inputs = (tree.prior, packed, tree.parent, tree.action_from,
              tree.expanded)
    empty = K.empty_pending(D, A, G, dev)
    n1, e1, sel = compare_select(
        K, inputs, empty, torch.rand((D, G), generator=gen, device=dev),
        CPUCT, scale)
    pend = pending_from(K, sel, tree.next_idx, A, scale, gen)
    probs = torch.rand((D, G), generator=gen, device=dev)
    n2, e2, _ = compare_select(K, inputs, pend, probs, CPUCT, scale)
    print(f"select_apply_packed parity, connect4 A={A} V={V} G={G} D={D}: "
          f"diverged lanes {n1}/{G} and {n2}/{G}, root_pi max abs err "
          f"{max(e1, e2):.3g}")
    sel_err = max(e1, e2)

    reps = 20
    copies = [(tree.prior.clone(), packed.clone()) for _ in range(reps + 1)]
    sel_ms = device_ms(lambda i: K.select_apply_packed(
        copies[i][0], copies[i][1], tree.parent, tree.action_from,
        tree.expanded, probs, pend, CPUCT, scale), reps)
    plain_copies = [(tree.prior.clone(), packed.clone()) for _ in range(4)]
    sel_plain_ms = wall_ms(lambda i: K.select_apply_packed_plain(
        plain_copies[i][0], plain_copies[i][1], tree.parent,
        tree.action_from, tree.expanded, probs, pend, CPUCT, scale), 3)
    print(f"select_apply_packed at the production shape: kernel "
          f"{sel_ms:.4f} ms, plain {sel_plain_ms:.2f} ms  [{card}]")

    # backup: the flush of a pending update onto the f32 stats
    value = torch.rand((G,), generator=gen, device=dev)
    bk = (tree.wsum.clone(), tree.visits.clone())
    bp = (tree.wsum.clone(), tree.visits.clone())
    K.backup(*bk, pend.nodes, pend.actions, pend.length, value)
    K.backup_plain(*bp, pend.nodes, pend.actions, pend.length, value)
    torch.cuda.synchronize()
    if not torch.equal(bk[1], bp[1]):
        raise AssertionError("backup: visits differ")
    torch.testing.assert_close(bk[0], bp[0], rtol=1e-6, atol=0.0)
    bk_err = float(max((bk[0] - bp[0]).abs().max(),
                       (bk[1] - bp[1]).abs().max()))
    bcopies = [(tree.wsum.clone(), tree.visits.clone())
               for _ in range(reps + 1)]
    bk_ms = device_ms(lambda i: K.backup(
        *bcopies[i], pend.nodes, pend.actions, pend.length, value), reps)
    bk_plain_ms = wall_ms(lambda i: K.backup_plain(
        *bcopies[i], pend.nodes, pend.actions, pend.length, value), 3)
    print(f"backup parity, connect4 A={A} V={V} G={G}: max abs err "
          f"{bk_err:.3g}; kernel {bk_ms:.4f} ms, plain {bk_plain_ms:.2f} ms"
          f"  [{card}]")
    del copies, plain_copies, bcopies

    # the synthetic wide shape
    Aw, Vw, Gw = 169, 64, 2048
    arrays = synthetic_tree(Aw, Vw, Gw, scale, SEED + 1)
    prior_w, wsum_w, visits_w, parent_w, af_w, exp_w, next_w = (
        torch.from_numpy(x).to(dev) for x in arrays)
    packed_w = K.pack_stats(wsum_w, visits_w, scale)
    inputs_w = (prior_w, packed_w, parent_w, af_w, exp_w)
    Dw = min(169, Vw)
    n1, e1, sel_w = compare_select(
        K, inputs_w, K.empty_pending(Dw, Aw, Gw, dev),
        torch.rand((Dw, Gw), generator=gen, device=dev), CPUCT, scale)
    pend_w = pending_from(K, sel_w, next_w, Aw, scale, gen)
    n2, e2, _ = compare_select(
        K, inputs_w, pend_w, torch.rand((Dw, Gw), generator=gen, device=dev),
        CPUCT, scale)
    wide_depth = float((sel_w.nodes >= 0).sum(0).float().mean())
    print(f"select_apply_packed parity, synthetic A={Aw} V={Vw} G={Gw}: "
          f"diverged lanes {n1}/{Gw} and {n2}/{Gw}, root_pi max abs err "
          f"{max(e1, e2):.3g}, mean path length {wide_depth:.2f}")
    sel_err = max(sel_err, e1, e2)
    bk = (wsum_w.clone(), visits_w.clone())
    bp = (wsum_w.clone(), visits_w.clone())
    vw = torch.rand((Gw,), generator=gen, device=dev)
    K.backup(*bk, pend_w.nodes, pend_w.actions, pend_w.length, vw)
    K.backup_plain(*bp, pend_w.nodes, pend_w.actions, pend_w.length, vw)
    if not torch.equal(bk[1], bp[1]):
        raise AssertionError("backup (wide): visits differ")
    torch.testing.assert_close(bk[0], bp[0], rtol=1e-6, atol=0.0)
    print("backup parity, synthetic wide shape: ok")
    del arrays, inputs_w, prior_w, wsum_w, visits_w, packed_w, bk, bp

    # ---- 4. the search on the card against the CPU path ----
    Gs = 512
    cpu = torch.device("cpu")
    net_cpu = MLP.from_seed(config_for_game(game), SEED, device=cpu)
    probs_s = torch.rand((V, D, Gs), generator=torch.Generator().manual_seed(1))
    searched = []
    for d, n in ((dev, net), (cpu, net_cpu)):
        t = init_tree(game, game.initial(Gs, d), V)
        _, pi = run_mcts(game, n, t, rollouts=V, cpuct=CPUCT, training=True,
                         probs=probs_s.to(d))
        searched.append((t, pi))
    (tg, pig), (tc, pic) = searched
    fields = ("parent", "action_from", "expanded", "next_idx", "wsum",
              "visits")
    bad = diverged_lanes(tuple(getattr(tg, f).cpu() for f in fields),
                         tuple(getattr(tc, f) for f in fields))
    n_bad = int(bad.sum())
    if n_bad > tie_limit(Gs):
        raise AssertionError(f"search card vs CPU: {n_bad} diverged lanes")
    ok = ~bad
    torch.testing.assert_close(tg.prior.cpu()[..., ok], tc.prior[..., ok],
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(pig.cpu()[:, ok], pic[:, ok], rtol=1e-4,
                               atol=1e-6)
    print(f"search on the card vs the CPU path (G={Gs}, R={V}): diverged "
          f"lanes {n_bad}/{Gs}")

    # ---- 5. the main path: continuous selfplay ----
    cfg = SelfplayConfig(num_games=G, rollouts=ROLLOUTS, cpuct=CPUCT,
                         rounds=CHUNK_ROUNDS)
    buf = create_buffer(game, capacity=1 << 20, device=dev)
    # warm-up (allocator, cuBLAS handles): two rounds, not counted
    selfplay_continuous(game, net, create_buffer(game, 1 << 14, device=dev),
                        torch.Generator(device=dev).manual_seed(SEED + 7),
                        cfg._replace(rounds=2))
    torch.cuda.synchronize()
    carry = make_carry(game, G, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    totals = {}
    for _ in range(CHUNKS):
        buf, stats, carry = selfplay_continuous(game, net, buf, None, cfg,
                                                carry)
        stats["length_sum"] = stats["mean_length"] * stats["games_finished"]
        for k, v in stats.items():
            totals[k] = totals.get(k, 0) + v
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"select_apply_packed": K.select_apply_packed.launches,
                "backup": K.backup.launches}
    totals = {k: float(v) for k, v in totals.items()}
    carried = float(stats["carried"])
    rounds = CHUNKS * CHUNK_ROUNDS
    env_steps = totals["samples_written"] + carried
    mean_len = totals["length_sum"] / max(totals["games_finished"], 1.0)
    print(f"selfplay: connect4 4x512, {G} lanes, {ROLLOUTS} rollouts, "
          f"{rounds} rounds in {CHUNKS} chained calls: "
          f"{env_steps / wall:.1f} env-steps/s, wall {wall:.3f} s, "
          f"env-steps {env_steps:.0f}, samples written "
          f"{totals['samples_written']:.0f}, games finished "
          f"{totals['games_finished']:.0f}, mean game length "
          f"{mean_len:.2f}, illegal moves {totals['illegal_moves']:.0f}"
          f"  [{card}]")
    print(f"launches in the main path: {launches}")
    if totals["illegal_moves"] != 0:
        raise AssertionError("illegal moves in selfplay")
    if not totals["samples_written"] > 0 or not totals["games_finished"] > 0:
        raise AssertionError("selfplay wrote no samples / finished no game")
    if launches["select_apply_packed"] != rounds * ROLLOUTS:
        raise AssertionError(f"select_apply_packed launched "
                             f"{launches['select_apply_packed']} times")
    if launches["backup"] != rounds:
        raise AssertionError(f"backup launched {launches['backup']} times")
    if env_steps != rounds * G:
        raise AssertionError("written + carried != rounds x lanes")
    n = int(buffer_size(buf))
    if n != int(totals["samples_written"]):
        raise AssertionError("buffer size != samples written")
    pol = buf.policy[:n]
    if not bool(torch.isfinite(pol).all()):
        raise AssertionError("non-finite policy rows")
    if not bool(((pol.sum(-1) - 1.0).abs() < 0.05).all()):
        raise AssertionError("policy rows do not sum to 1")
    values = torch.unique(buf.value[:n]).tolist()
    if not set(values) <= {0.0, 0.5, 1.0}:
        raise AssertionError(f"back-filled values {values}")

    # ---- 6. result ----
    print(json.dumps({"kernels": [
        {"name": "select_apply_packed", "route": "cuda",
         "source": SELECT_SOURCE,
         "replaces": "alphatpu/mcts/pallas_kernels.py:1008",
         "launches": launches["select_apply_packed"],
         "max_abs_err": sel_err, "ms": sel_ms, "plain_ms": sel_plain_ms},
        {"name": "backup", "route": "cuda", "source": BACKUP_SOURCE,
         "replaces": "alphatpu/mcts/pallas_kernels.py:1349",
         "launches": launches["backup"], "max_abs_err": bk_err,
         "ms": bk_ms, "plain_ms": bk_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
