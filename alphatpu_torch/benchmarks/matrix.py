"""The config matrix: :func:`alphatpu_torch.bench.measure` over every
headline workload of ``BASELINE.json``, one JSON line per row.

    python -m alphatpu_torch.benchmarks.matrix [out.json]

Counterpart of ``benchmarks/matrix.py``, with its 19 rows as they stand:
each game with its reference net at the single-card lane count, f32 and
bf16 inference, the 32,768-lane connect4 row (four 8192-lane superblocks),
the 13x13 boards at 2048 lanes in 16-round chunks, and six rows at engine
level 2.  Pack 0 is the production default, level 1.  A row that fails is
recorded with its error and the matrix goes on; the exit code is nonzero
if any row failed.  Output (default ``chiprun_out/matrix_torch.json``
under the repository root) is rewritten after each row.

Env: MATRIX_GAMES (lane count, default 8192), MATRIX_ROLLOUTS (64).
"""
from __future__ import annotations

import json
import os
import sys
import traceback
from pathlib import Path

from ..bench import measure

LANES = int(os.environ.get("MATRIX_GAMES", 8192))
ROLLOUTS = int(os.environ.get("MATRIX_ROLLOUTS", 64))
DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "chiprun_out"
               / "matrix_torch.json")

# (game, lanes, bf16, chunk, rounds, pack): chunk > 0 runs the generation
# as chained calls of ``chunk`` rounds; rounds 0 takes the bench's default
# (>= 2 full games per lane); pack 0 is level 1, pack 2 level 2
CONFIGS = [
    ("tictactoe", 1024, False, 0, 0, 0),
    ("connect4", LANES, False, 0, 0, 0),
    ("connect4", LANES, True, 0, 0, 0),
    # the reference's literal 32,768-game shape
    ("connect4", 32768, False, 84, 0, 0),
    ("hex7", LANES, False, 0, 0, 0),
    ("hex7", LANES, True, 0, 0, 0),
    ("gobang9", LANES, False, 0, 0, 0),
    ("gobang9", LANES, True, 0, 0, 0),
    ("reversi6x6", LANES, False, 0, 0, 0),
    ("reversi8x8", LANES, False, 0, 0, 0),
    ("reversi8x8", LANES, True, 0, 0, 0),
    # the 13x13 boards (A=169)
    ("hex13", 2048, False, 16, 352, 0),
    ("gobang13", 2048, False, 16, 352, 0),
    # engine level 2, the 1-plane packed word
    ("connect4", LANES, False, 0, 0, 2),
    ("hex7", LANES, False, 0, 0, 2),
    ("gobang9", LANES, False, 0, 0, 2),
    ("reversi8x8", LANES, False, 0, 0, 2),
    ("hex13", 2048, False, 16, 352, 2),
    ("gobang13", 2048, False, 16, 352, 2),
]


def run_rows(rows, out_path, rollouts: int = ROLLOUTS, device="cuda",
             log=print) -> list:
    """:func:`measure` each row; a failing row is recorded as
    ``{"metric", "error"}``.  Returns the results, also written to
    ``out_path`` after each row."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    for game, lanes, bf16, chunk, rounds, pack in rows:
        level = pack or 1
        try:
            r = measure(game, games=lanes, rollouts=rollouts, bf16=bf16,
                        chunk=chunk, rounds=rounds, pack_level=level,
                        device=device)
        except Exception as e:  # record the failure, go on to the next row
            traceback.print_exc()
            r = {"metric": f"{game}_g{lanes}" + ("_bf16" if bf16 else "")
                 + (f"_l{level}" if level != 1 else ""),
                 "error": f"{type(e).__name__}: {e}"}
        log(json.dumps(r))
        results.append(r)
        out_path.write_text(json.dumps(results, indent=1))
    log(f"wrote {out_path}")
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    results = run_rows(CONFIGS, argv[0] if argv else DEFAULT_OUT,
                       log=lambda line: print(line, flush=True))
    return 1 if any("error" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
