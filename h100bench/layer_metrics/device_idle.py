"""device_idle: the share of the profiled requests' spans in which no
operation ran on the card, in %: 1 - (union of the device operations'
intervals) / (the spans)."""


def read(ctx, variant):
    if ctx.trace is None or ctx.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s())
