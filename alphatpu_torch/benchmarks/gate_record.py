"""Write a gate: the first generations of a ``train_record`` run, kept
beside a record.

    python -m alphatpu_torch.benchmarks.gate_record \\
        --run <train_record's --out> --out Datahex7_torch \\
        [--reference Datahex7/stats.jsonl] [--compare <another run's --out>]

Reads ``<run>/record_run.json`` and ``<run>/stats.jsonl`` (a
``train_record`` run of ``GATE_GENERATIONS`` generations, no probe) and
writes ``<out>/gate.json`` and ``<out>/gate_stats.jsonl``: the card, the
CLI's command and engine, each generation's stats with its seconds by
stage (``checkpoint_s`` is the wall less the three stages: the
checkpoint, and on the first generation also the process start, the
kernels' build and the captures), and the time ``PROJECTED``
generations (a record's) would take: the first generation's seconds and
the second's for each later one, since every generation of the
continuous mode plays the same rounds.  With ``--reference`` each
generation also holds the reference's ``samples_written`` and the gap to
it.  With ``--compare`` (the same gate run on another tree)
``gate.json`` holds that run's seconds, samples and losses beside this
one's, and whether they are equal generation for generation.  The JSON
is also the last line on stdout; the exit code is 1 where a line shows
an illegal move or an unfinished game, or where ``--compare``'s samples
or losses differ.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .train_record import GATE_GENERATIONS, line_fault, read_reference

CALL_SECONDS = 3300  # a record is trained in one call: 3600 s less margin
PROJECTED = 60  # the generations of a record
STAGES = ("selfplay_s", "train_s", "duel_s")


def read_run(run: str):
    with open(os.path.join(run, "record_run.json")) as f:
        record = json.load(f)
    with open(os.path.join(run, "stats.jsonl")) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    return record, lines


def generations(record: dict, lines: list, reference: dict | None) -> list:
    """Each stats line's fields with its wall and its checkpoint seconds
    (the wall less the three stages)."""
    out = []
    walls = record["training"]["seconds_per_generation"]
    for line, wall in zip(lines, walls):
        g = {k: line[k] for k in ("generation", "samples_written")}
        if reference is not None:
            ref = reference[line["generation"]]["samples_written"]
            g.update(reference_samples_written=ref,
                     gap=round(line["samples_written"] / ref - 1, 5))
        g.update({k: line[k] for k in (
            "carried", "games_finished", "mean_length", "loss",
            "illegal_moves", "unfinished", *STAGES)})
        g.update(checkpoint_s=round(wall - sum(line[k] for k in STAGES), 3),
                 seconds=wall)
        out.append(g)
    return out


def projection(seconds: list, generations: int) -> dict:
    total = seconds[0] + (generations - 1) * seconds[1]
    return {"formula": f"generation 1's seconds + {generations - 1} x "
                       "generation 2's",
            f"seconds_{generations}_generations": round(total, 3),
            "fits_one_call": total <= CALL_SECONDS,
            "note": f"a record is trained in one call where this is at "
                    f"most {CALL_SECONDS} s (a call allows 3600 s; the "
                    "buffer cannot join two calls)"}


def compare(lines: list, other: list, other_seconds: list) -> dict:
    same = [a["samples_written"] == b["samples_written"]
            and a["loss"] == b["loss"] for a, b in zip(lines, other)]
    return {"seconds_per_generation": other_seconds,
            "samples_written": [x["samples_written"] for x in other],
            "loss": [x["loss"] for x in other],
            "equal": len(lines) == len(other) and all(same)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="alphatpu_torch.benchmarks."
                                 "gate_record", description=__doc__)
    ap.add_argument("--run", required=True,
                    help="a train_record run's --out directory")
    ap.add_argument("--out", required=True,
                    help="gate.json and gate_stats.jsonl go here")
    ap.add_argument("--reference", default=None,
                    help="the reference's stats.jsonl for the game")
    ap.add_argument("--compare", default=None,
                    help="the same gate's --out directory on another tree")
    args = ap.parse_args(argv)

    record, lines = read_run(args.run)
    reference = read_reference(args.reference)
    if len(lines) != GATE_GENERATIONS:
        raise SystemExit(f"{args.run}: {len(lines)} stats lines, a gate "
                         f"has {GATE_GENERATIONS}")
    faults = [f for f in (line_fault(x, reference) for x in lines) if f]
    seconds = record["training"]["seconds_per_generation"]
    gate = {"game": record["game"], "card": record["card"],
            "torch": record["torch"], "stats": "gate_stats.jsonl",
            "training": record["training"],
            "generations": generations(record, lines, reference),
            "projection": projection(seconds, PROJECTED),
            "faults": faults}
    ok = record["training"]["rc"] == 0 and not faults
    if args.compare:
        other_record, other = read_run(args.compare)
        gate["compared"] = {
            "run": args.compare,
            "card": other_record["card"],
            **compare(lines, other,
                      other_record["training"]["seconds_per_generation"])}
        ok = ok and gate["compared"]["equal"]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "gate.json"), "w") as f:
        json.dump(gate, f, indent=1)
        f.write("\n")
    with open(os.path.join(args.out, "gate_stats.jsonl"), "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    print(json.dumps(gate))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
