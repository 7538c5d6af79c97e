"""sample_escalations: mean samples per predict whose sampling factor needed
a jitter rung past the first (the program's
``last_predict_report["sample_factor_escalations"]``, counted by
``gpar_torch.ops.linalg.psd_sample_factor_batched``).  None for a program
without the report."""

import numpy as np


def read(ctx, variant):
    recs = [r["predict_report"] for r in ctx.records if "predict_report" in r]
    return float(np.mean([r["sample_factor_escalations"] for r in recs])) if recs else None
