"""gram_launches: mean forward Gram kernel launches per request
(``gpar_torch.ops.gram_kernel.counters()["gram_kernel_launches"]``, set to 0
before each request)."""

import numpy as np


def read(ctx, variant):
    if not ctx.records:
        return None
    return float(np.mean([r["counters"]["gram_kernel_launches"] for r in ctx.records]))
