"""Where the time of one generation goes, by stage, under ``torch.profiler``.

    python -m alphatpu_torch.profile_generation --out profile.json

Builds the best net from seed 0 (or a checkpoint's best net, ``--ckpt``:
the trees a trained net grows) and the learner's copy, runs the whole
generation-mode selfplay stage unprofiled (its wall time, and the buffer
the train window reads), runs the selfplay and duel windows' calls once
unprofiled (on the card this captures their rounds: the windows replay
them), then profiles one window of each stage:

* selfplay: the first ``--rounds`` rounds of ``selfplay_generation``,
* train: one ``train_epoch`` over that buffer,
* duel: the first ``--rounds`` rounds of one ``duel_half``,
* checkpoint: ``save_checkpoint`` with the buffer.

Per window it prints (and writes to ``--out``) one JSON object: wall time,
device busy time (the sum of the device kernels' time), the idle share
``1 - busy / wall``, device kernel launches (and per rollout for the
search windows), the CUDA graphs replayed and captured in the window
(:mod:`alphatpu_torch.graphs`) and the device kernels per replay, host
copy and sync calls, the top device kernels, and the device ms and
launches of each game-rules kernel by name (``rules_kernels``: they sit
below the top eight).  ``--eager`` runs the
rounds eagerly instead (``captured=False``), for comparison.  On the CPU
(``--device cpu``) it gives the wall times only.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

from . import checkpoint as ckpt
from . import graphs, resolve_device
from .buffer import create_buffer
from .duel import DuelConfig, duel_half
from .games import make_game
from .nets import MLP, config_for_game, params_from_jax
from .selfplay import SelfplayConfig, selfplay_generation
from .train import TrainConfig, adam_init, train_epoch

HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync")
# the game rules' kernels (csrc/rules.cu), as the profiler names them
RULES_KERNELS = ("reversi_play_kernel", "reversi_is_over_kernel",
                 "line_is_over_kernel", "hex_is_over_kernel")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def window(name: str, fn, device: torch.device, rollouts: int | None = None):
    """Profile one call of ``fn``; ``rollouts`` is the number of searched
    rollouts in it (for launches per rollout)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    graphs.reset_counts()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    replays, captures = graphs.counts["replays"], graphs.counts["captures"]
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy_ms = sum(by_name.values())
    rec = {"window": name, "wall_ms": wall_ms, "graph_replays": replays,
           "graph_captures": captures}
    if cuda:  # no device metric exists on a CPU run
        rec.update({
            "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": len(kernels),
            "launches_per_rollout": (len(kernels) / rollouts if rollouts
                                     else None),
            "launches_per_replay": (len(kernels) / replays if replays
                                    else None),
            "host_copy_or_sync_calls": sum(1 for e in events
                                           if e.name in HOST_SYNCS),
            "top_kernels_ms": top_kernels(by_name),
            "rules_kernels": rules_kernels(kernels),
        })
    print(json.dumps(rec))
    return rec


def rules_kernels(kernels) -> dict:
    """Each rules kernel's device ms and launches in the window, by the
    name of its ``__global__`` function (every instantiation summed)."""
    out = {}
    for name in RULES_KERNELS:
        pattern = re.compile(rf"\b{name}\b")
        rows = [e for e in kernels if pattern.search(e.name)]
        out[name] = {"ms": sum(e.device_time_total for e in rows) / 1e3,
                     "launches": len(rows)}
    return out


def top_kernels(by_name: dict, n: int = 8) -> list:
    """The ``n`` kernels of most device time, ``(name, ms)``, names whole:
    a templated kernel's functor and dtype sit at the end of its name."""
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--game", default="connect4")
    p.add_argument("--games", type=int, default=8192,
                   help="selfplay games (the duel half plays a sixteenth)")
    p.add_argument("--rollouts", type=int, default=64,
                   help="selfplay rollouts (the duel searches half as many)")
    p.add_argument("--rounds", type=int, default=4,
                   help="rounds in the selfplay and duel windows")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--ckpt", default=None,
                   help="net<N>.npz: its best net, at the game's reference "
                        "size, in place of seed 0's")
    p.add_argument("--device", default="cuda")
    p.add_argument("--eager", action="store_true",
                   help="run the rounds eagerly, not from CUDA graphs")
    p.add_argument("--out", default=None, help="write the windows as JSON")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    captured = graphs.use_graphs(False if args.eager else None, dev)
    game = make_game(args.game)
    kw = {k: v for k, v in (("width", args.width), ("depth", args.depth))
          if v is not None}
    if args.ckpt:
        with np.load(args.ckpt) as z:
            best = params_from_jax(dict(z), config_for_game(game), device=dev,
                                   prefix="best/")
    else:
        best = MLP.from_seed(config_for_game(game, **kw), 0, device=dev)
    learner = best.copy(trainable=True)
    opt = adam_init(learner)
    gen = torch.Generator(device=dev).manual_seed(0)
    G, R, T = args.games, args.rollouts, game.max_game_length
    duel = DuelConfig(num_games=max(G // 16, 1), rollouts=max(R // 2, 1))
    sp_cfg = SelfplayConfig(num_games=G, rollouts=R)
    card = card_line()
    print(card)

    k = args.rounds
    # one buffer for every window: the captured tail writes it by address
    window_buf = create_buffer(game, G * k, device=dev)

    def selfplay_window():
        selfplay_generation(game, best, window_buf, gen,
                            sp_cfg._replace(max_moves=k), captured=captured)

    def duel_window():
        duel_half(game, learner, best, gen, duel._replace(max_moves=k), dev,
                  captured=captured)

    # the whole selfplay stage, unprofiled: its wall (a capture included),
    # and the buffer the train window reads
    buf = create_buffer(game, G * T, device=dev)
    graphs.reset_counts()
    t0 = time.perf_counter()
    _, stats = selfplay_generation(game, best, buf, gen, sp_cfg,
                                   captured=captured)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    full = {"full_selfplay_s": time.perf_counter() - t0,
            "samples_written": int(stats["samples_written"]),
            "captured": captured, **graphs.counts}
    print(json.dumps(full))
    # warm-up (allocator, cuBLAS handles, and the windows' captures),
    # unprofiled
    graphs.reset_counts()
    selfplay_window()
    duel_window()
    warm = dict(graphs.counts)
    print(json.dumps({"warm_up": warm}))

    windows = [
        window(f"selfplay, rounds 1-{k} of {T}, {G} games", selfplay_window,
               dev, k * R),
        window("train, one epoch",
               lambda: train_epoch(learner, opt, buf, gen, TrainConfig()),
               dev),
        window(f"duel, one half, rounds 1-{k} of {T}, {duel.num_games} "
               "games", duel_window, dev, k * duel.rollouts),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        windows.append(window(
            "checkpoint with the buffer",
            lambda: ckpt.save_checkpoint(
                tmp, 1, best_net=best, train_net=learner, opt_state=opt,
                elo=0.0, best_generation=0, rng=gen, buffer=buf), dev))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "args": vars(args), **full,
                       "warm_up": warm, "windows": windows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
