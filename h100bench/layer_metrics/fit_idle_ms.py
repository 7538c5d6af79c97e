"""fit_idle_ms: device-idle ms per profiled request inside the program's
``gpar.fit`` span and the spans under it (``h100bench.lib.spans``): the card
waiting on the host during the fit."""

from h100bench.lib import spans


def read(ctx, variant):
    if ctx.trace is None:
        return None
    return spans.per_request_ms(spans.idle_inside_ns(ctx.trace, "gpar.fit"), ctx)
