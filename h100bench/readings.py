"""The readings that set ``h100bench/limits/<cell>.json``: the numbers
compared with the reference, for the program as it is, for the control
(the reference in the precision below the configuration's, in the
program's place) and for
the program with a fault planted (``h100bench/lib/faults.py``).

    python3 h100bench/readings.py --workload <cell> --seeds 1,2,3 --seconds 8 [--control] [--fault F]

One process runs the cell once per seed, each a short window that
completes the requests a run checks, and writes one JSON line per seed to
standard output and to ``--out``.  A fault is planted before anything runs,
so that the CUDA graphs are captured with it.  Not part of a benchmark run.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench.lib import cell, faults

    spec = cell.Spec(args.workload)
    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    with faults.plant(args.fault) if args.fault else contextlib.nullcontext():
        for seed in (int(s) for s in args.seeds.split(",")):
            result, _ = cell.run(spec, seed, args.seconds, bool(args.trace), log=log,
                                 control=args.control)
            line = json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                               **result})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
