"""evaluations: mean layer evaluations per fit as the report gives them:
layer starts, L-BFGS iterations and backtracking trials."""

import numpy as np

from h100bench.lib.work import evaluations


def read(ctx, variant):
    recs = [r for r in ctx.records if "report" in r]
    return float(np.mean([evaluations(r["report"]) for r in recs])) if recs else None
