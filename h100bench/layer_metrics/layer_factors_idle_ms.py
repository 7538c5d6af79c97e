"""layer_factors_idle_ms: device-idle ms per profiled request inside the
program's ``gpar.predict.layer_factors`` spans (``h100bench.lib.spans``):
the card waiting on the host while the per-sample tail takes each layer's
training factors, computed anew with the imputation of the layer before
where they are not cached."""

from h100bench.lib import spans


def read(ctx, variant):
    if ctx.trace is None:
        return None
    return spans.per_request_ms(spans.idle_inside_ns(ctx.trace, "gpar.predict.layer_factors"),
                                ctx)
