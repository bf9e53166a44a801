"""Run one cell of the benchmark once, on the machine's first card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output, one JSON object;
the numbers the check compared, each beside its limit, are the last lines
of standard error.  Exits with 1, and prints no result, where torch finds
no CUDA card or fewer cards than the cell asks for, or where JAX or the
JAX package is loaded once the window has closed.  Set-up is counted
from this module's start.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / "_cache"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--tower-dtype", default=None,
                   help="run the program's tower in this type (bfloat16: "
                        "the check's control); the reference keeps the "
                        "configuration's")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every build and kernel cache the program's libraries may keep, at
    # fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness, spec

    bench = spec.load_benchmark(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch finds no CUDA device: the benchmark runs on the card "
              "only", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} cards, torch "
              f"finds {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    cell = spec.cell(args.workload, ROOT, bench)
    out = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T0, tower_dtype=args.tower_dtype)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 1
    print(f"set-up {out.pop('setup_parts')}", file=sys.stderr)
    print(f"seconds to each window call's end {out.pop('call_s')}",
          file=sys.stderr)
    print(f"checked {out.pop('checked')}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
