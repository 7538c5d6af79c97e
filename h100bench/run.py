"""The H100 benchmark of ``gpar_torch``: one run of one cell.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The cells,
their configurations, traffic and metrics are named in ``BENCHMARK.json``;
``h100bench/lib/cell.py`` runs one.  The last line of standard output is
the result as one JSON object; the numbers compared with the reference,
each beside its limit, are the last lines of standard error.  A run exits
with a code other than 0, and prints no result, without a CUDA card, or
if ``jax``, ``jaxlib``, ``flax`` or ``gpar_tpu`` is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def card_line():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every cache the program or torch keeps lives at a fixed path inside
    # the checkout (the port's own kernels build into build/gpar_torch/).
    cache = ROOT / "build" / "h100bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    from h100bench.lib import cell

    spec = cell.Spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec.cell["chips"]):
        print(f"h100bench: the cell needs {spec.cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    log(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result, rows = cell.run(spec, args.seed, args.seconds, bool(args.trace), t_start=T_START,
                            log=log)
    bad = cell.forbidden_modules()
    if bad:
        log(f"h100bench: modules that no run may load are loaded: {bad}")
        return 3
    for name, v, lim in rows:
        log(f"[check] {name} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
