"""Train a net through the port's CLI and probe it, as a record is made.

    python -m alphatpu_torch.benchmarks.train_record --game connect4 \\
        --generations 60 --ckpt-dir _local/c4 --out _local/c4_record \\
        --probe-at 20 40 60 --reference Dataconnect4/stats.jsonl

Runs ``python -m alphatpu_torch.cli`` with the reference's quick-start
flags (``QUICK_START``: ``--samples 8192 --continuous --rollout 64
--batchsize 8192``, the per-game net) for ``--generations`` generations,
appending its stats to ``<out>/stats.jsonl`` and its log to
``<out>/train.log``, and times each generation as its stats line lands
(selfplay, train, duel and checkpoint; the first also holds the process
start and the kernels' build).  Every
line must show ``illegal_moves == 0`` and ``unfinished == 0``, or the run
is stopped.  With ``--reference`` (the reference's ``stats.jsonl`` for
the game), the first ``GATE_GENERATIONS`` generations must each write
within 10% of the samples the reference's same generation wrote, or the
run is stopped.

Then the probes at ``--probe-at`` run at once, one process each (``python
-m alphatpu_torch.probe``: the game's probe with the reference's
protocol - the games of the reference's ``probe.json`` beside
``--reference``'s ``stats.jsonl``, ``PROBE_GAMES`` without one, of
``PROBE_ROLLOUT`` rollouts and ``--temp-moves`` sampled plies: 8 unless
the record's protocol says otherwise, as tictactoe's 2), each timed.
The checkpoints of the probed generations, the last one and
``latest.json`` are copied into ``<out>`` (the others stay in
``--ckpt-dir``: a generation's is tens of MiB).

A record too long for one call splits in two: ``--train-only`` trains
and keeps the nets of ``--probe-at`` in ``<out>`` without probing them;
a later ``--probe-only`` call, with ``--ckpt-dir`` set to that ``<out>``,
probes them and writes the earlier call's ``training`` block beside its
``probes`` (the nets travel from the first call's ``<out>`` to the
second call's copy by hand).

``<out>/record_run.json`` holds the card, the commands, the probes'
games and ``temp_moves``, the engine (``training.engine``: the switches
``ENGINE_SWITCHES`` as the environment sets them and the level
``mcts.search.engine_level`` resolves from them; the CLI and the probes
inherit the environment, so one level holds for all), the seconds of
each generation and each probe's W/D/L; the same object is the last
line on stdout.  Exit 0 only when every step held.  Flags after ``--``
go to the CLI as they are, after the quick-start flags, so they
override them (a smaller run on the CPU; gobang13's 2048 lanes).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

GATE_TOLERANCE = 0.10  # relative gap of samples_written to the reference
GATE_GENERATIONS = 2  # the generations held to the reference's
# the reference's quick-start flags (README.md's training command)
QUICK_START = ["--samples", "8192", "--continuous", "--rollout", "64",
               "--batchsize", "8192"]
# the reference's probe protocol (Data<game>/probe.json): another one
# makes a record that cannot be compared
PROBE_GAMES = 64
PROBE_ROLLOUT = 64
# the environment switches that pick the search engine
ENGINE_SWITCHES = ("ALPHATPU_PACK", "ALPHATPU_NO_PACK", "ALPHATPU_BF16_STATS")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, or what stands in for them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no nvidia-smi output"
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def cli_command(args) -> list:
    return [sys.executable, "-m", "alphatpu_torch.cli", "--game", args.game,
            *QUICK_START, "--generation", str(args.generations),
            "--ckpt-dir", args.ckpt_dir,
            "--stats-file", os.path.join(args.out, "stats.jsonl"),
            "--device", args.device, *args.cli_extra]


def probe_command(args, generation: int) -> list:
    return [sys.executable, "-m", "alphatpu_torch.probe", "--game", args.game,
            "--ckpt", os.path.join(args.ckpt_dir, f"net{generation}.npz"),
            "--games", str(args.probe_games), "--rollout",
            str(PROBE_ROLLOUT), "--temp-moves", str(args.temp_moves),
            "--device", args.device]


def probe_games(reference: str | None) -> int:
    """The games of the reference's probe (``probe.json`` in the directory
    of its ``stats.jsonl``: gobang13 was probed with 32), else
    ``PROBE_GAMES``."""
    if reference is None:
        return PROBE_GAMES
    with open(os.path.join(os.path.dirname(reference), "probe.json")) as f:
        return json.load(f)["games"]


def engine(cli_cmd: list) -> dict:
    """The engine switches as the environment sets them, and the level
    ``run_mcts`` resolves from them at the CLI's ``--rollout`` (the last
    one given wins, as argparse reads it)."""
    from alphatpu_torch.mcts.search import engine_level
    from alphatpu_torch.mcts.tree import stat_dtype_for

    rollout = int([v for k, v in zip(cli_cmd, cli_cmd[1:])
                   if k == "--rollout"][-1])
    return {**{k: os.environ.get(k) for k in ENGINE_SWITCHES},
            "level": engine_level(None, True, stat_dtype_for(rollout))}


def line_fault(line: dict, reference: dict | None) -> str | None:
    """Why a stats line stops the run, or None."""
    if line["illegal_moves"] or line["unfinished"]:
        return (f"generation {line['generation']}: illegal_moves "
                f"{line['illegal_moves']}, unfinished {line['unfinished']}")
    if reference is not None and line["generation"] in reference:
        ref = reference[line["generation"]]["samples_written"]
        gap = line["samples_written"] / ref - 1
        if abs(gap) > GATE_TOLERANCE:
            return (f"generation {line['generation']}: samples_written "
                    f"{line['samples_written']} against the reference's "
                    f"{ref} ({gap:+.3f})")
    return None


def read_reference(path: str | None) -> dict | None:
    if path is None:
        return None
    with open(path) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    return {x["generation"]: x for x in lines
            if x["generation"] <= GATE_GENERATIONS}


def train(args, stats_path: str, reference: dict | None) -> dict:
    """The CLI run, watched: seconds per generation, its exit code and
    the fault that stopped it, if any."""
    start_lines = 0
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            start_lines = sum(1 for x in f if x.strip())
    cmd = cli_command(args)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = last = time.time()
    seconds, fault = [], None
    with open(os.path.join(args.out, "train.log"), "a") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env)
        while True:
            done = proc.poll() is not None
            lines = []
            if os.path.exists(stats_path):
                with open(stats_path) as f:
                    lines = [json.loads(x) for x in f if x.endswith("\n")]
            now = time.time()
            for line in lines[start_lines + len(seconds):]:
                seconds.append(round(now - last, 3))
                last = now
                fault = fault or line_fault(line, reference)
            if fault and not done:
                proc.kill()
                proc.wait()
                break
            if done:
                break
            time.sleep(0.25)
    return {"command": "python " + " ".join(cmd[1:]),
            "engine": engine(cmd), "rc": proc.returncode, "fault": fault,
            "seconds_per_generation": seconds,
            "seconds": round(time.time() - t0, 3)}


def probe(args) -> list:
    """The probes at ``--probe-at``, all at once; each one's W/D/L and
    seconds."""
    procs = []
    for g in args.probe_at:
        cmd = probe_command(args, g)
        procs.append((g, cmd, time.time(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    runs = []
    for g, cmd, t0, proc in procs:
        out, err = proc.communicate()
        run = {"generation": g, "temp_moves": args.temp_moves,
               "rc": proc.returncode,
               "seconds": round(time.time() - t0, 3),
               "command": "python " + " ".join(cmd[1:])}
        if proc.returncode == 0:
            res = json.loads(out.strip().splitlines()[-1])
            run.update({k: res[k] for k in ("net_wins", "draws",
                                            "net_losses")})
        else:
            run["error"] = err.strip().splitlines()[-1:] or ["no output"]
        runs.append(run)
    return runs


def keep_nets(args) -> None:
    """Copy the probed generations' checkpoints, the last one and
    ``latest.json`` from ``--ckpt-dir`` into ``--out``."""
    with open(os.path.join(args.ckpt_dir, "latest.json")) as f:
        last = json.load(f)["index"]
    for g in sorted({*args.probe_at, last}):
        shutil.copy(os.path.join(args.ckpt_dir, f"net{g}.npz"), args.out)
    shutil.copy(os.path.join(args.ckpt_dir, "latest.json"), args.out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="alphatpu_torch.benchmarks."
                                 "train_record", description=__doc__)
    ap.add_argument("--game", required=True)
    ap.add_argument("--generations", type=int, default=60)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True,
                    help="stats.jsonl, train.log, the probed and the "
                         "last checkpoints and record_run.json go here")
    ap.add_argument("--probe-at", type=int, nargs="*", default=[],
                   help="generations to probe once training ends; their "
                         "nets are kept in --out")
    ap.add_argument("--reference", default=None,
                    help="the reference's stats.jsonl for the game: the "
                         f"first {GATE_GENERATIONS} generations' "
                         "samples_written must each be within 10%% of its")
    ap.add_argument("--temp-moves", type=int, default=8,
                    help="the probes' sampled plies (the probe CLI's "
                         "--temp-moves; the reference probed tictactoe "
                         "with 2); the CLI's own --temp-moves goes after --")
    ap.add_argument("--device", default="cuda")
    split = ap.add_mutually_exclusive_group()
    split.add_argument("--train-only", action="store_true",
                       help="train and keep the nets of --probe-at in "
                            "--out; no probe")
    split.add_argument("--probe-only", action="store_true",
                       help="no training: probe the nets of --probe-at in "
                            "--ckpt-dir, an earlier --train-only call's "
                            "--out, beside its training block")
    ap.add_argument("cli_extra", nargs="*",
                    help="more CLI flags, after --")
    args = ap.parse_args(argv)
    args.probe_games = probe_games(args.reference)

    os.makedirs(args.out, exist_ok=True)
    record = {"game": args.game, "card": card_line(),
              "temp_moves": args.temp_moves,
              "probe_games": args.probe_games}
    import torch

    record["torch"] = f"{torch.__version__}, CUDA {torch.version.cuda}"
    if args.probe_only:
        earlier = os.path.join(args.ckpt_dir, "record_run.json")
        with open(earlier) as f:
            trained = json.load(f)
        if not trained["ok"] or trained["game"] != args.game:
            raise SystemExit(f"{earlier}: no good {args.game} training")
        record["training"] = trained["training"]
        record["training_record"] = earlier
        ok = True
    else:
        stats_path = os.path.join(args.out, "stats.jsonl")
        record["training"] = train(args, stats_path,
                                   read_reference(args.reference))
        ok = (record["training"]["rc"] == 0
              and not record["training"]["fault"])
        if ok:
            keep_nets(args)
    if ok and not args.train_only:
        record["probes"] = probe(args)
        ok = all(r["rc"] == 0 for r in record["probes"])
    record["ok"] = ok
    with open(os.path.join(args.out, "record_run.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
