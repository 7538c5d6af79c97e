"""ladder_escalations: mean Cholesky factorisations per fit that needed a
jitter rung past the first (the program's
``last_fit_report["ladder_escalations"]``, counted by
``gpar_torch.ops.linalg.cholesky_ladder_on_device``): how often the fit's
repair path engages.  None without fit records."""

import numpy as np


def read(ctx, variant):
    recs = [r["report"] for r in ctx.records if "report" in r]
    return float(np.mean([r["ladder_escalations"] for r in recs])) if recs else None
