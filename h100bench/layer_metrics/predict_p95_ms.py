"""predict_p95_ms: the 95th percentile of the window's ``predict`` latencies,
in ms, over every served request of the window."""

import numpy as np


def read(ctx, variant):
    walls = [r["wall_s"] for r in ctx.records if "report" not in r]
    if not walls:
        return None
    return float(1e3 * np.percentile(walls, 95))
