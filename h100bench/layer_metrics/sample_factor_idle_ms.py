"""sample_factor_idle_ms: device-idle ms per profiled request inside the
program's ``gpar.predict.sample_factor`` spans (``h100bench.lib.spans``):
the card waiting on the host in the per-sample tail's batched sampling
factors, whose rungs each read ``info`` back to the host."""

from h100bench.lib import spans


def read(ctx, variant):
    if ctx.trace is None:
        return None
    return spans.per_request_ms(spans.idle_inside_ns(ctx.trace, "gpar.predict.sample_factor"),
                                ctx)
