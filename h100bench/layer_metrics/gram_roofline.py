"""gram_roofline: the Gram kernels' share of their roofline in the profiled
requests, in %: the least time of the Grams the requests' mathematics needs
(the entry's work counts, ``h100bench.lib.work``: at the real rows and each
layer's own width) over the device time of ``gram_tile_kernel``,
``gram_bwd_kernel`` and ``gram_bwd_reduce``."""

import re

KERNELS = re.compile(r"gram_tile_kernel|gram_bwd_kernel|gram_bwd_reduce")


def read(ctx, variant):
    if ctx.trace is None or not ctx.traced:
        return None
    t = ctx.trace.device_s(lambda name: bool(KERNELS.search(name)))
    if t <= 0:
        return None
    bound_ms = sum(ctx.work(r)[1] for r in ctx.traced)
    return 100.0 * bound_ms / 1e3 / t
