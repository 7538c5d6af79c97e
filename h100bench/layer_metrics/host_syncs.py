"""host_syncs: mean host reads per fit (``last_fit_report["host_syncs"]``):
one per L-BFGS iteration, backtracking trial and episode, and one for the
results."""

import numpy as np


def read(ctx, variant):
    recs = [r for r in ctx.records if "report" in r]
    return float(np.mean([r["report"]["host_syncs"] for r in recs])) if recs else None
