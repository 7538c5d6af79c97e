"""Small configurations of the benchmark's cells for the CPU tests."""

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def config(name, **over):
    """Configuration ``name`` cut to a size the CPU runs in seconds: p = 3,
    16 inducing points, 150-200 rows, 20 test inputs and draws, and the
    configuration's 10 iterations (the gradient ratio that a sound fit
    reads depends on them)."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(p=3, rows=[150, 200], serve_rows=180, test_points=20, samples=20, iters=10)
    if cfg["model"]["inducing"]:
        cfg["model"]["inducing"] = 16
    cfg.update(over)
    return cfg
