"""tail_idle_ms: device-idle ms per profiled request inside the program's
``gpar.predict.tail`` spans and the spans under them
(``h100bench.lib.spans``): the card waiting on the host in the predictive's
tail, its factors where they are not cached and its draws."""

from h100bench.lib import spans


def read(ctx, variant):
    if ctx.trace is None:
        return None
    return spans.per_request_ms(spans.idle_inside_ns(ctx.trace, "gpar.predict.tail"), ctx)
