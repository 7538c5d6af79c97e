"""predict_tail_s: mean seconds per fit_predict request after its fit ended,
the request's wall-clock less the fit's own (``last_fit_report
["wall_clock_s"]``): conditioning and the Monte-Carlo predictive."""

import numpy as np


def read(ctx, variant):
    recs = [r for r in ctx.records if "report" in r]
    if not recs:
        return None
    return float(np.mean([r["wall_s"] - r["report"]["wall_clock_s"] for r in recs]))
