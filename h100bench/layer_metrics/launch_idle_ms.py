"""launch_idle_ms: device-idle ms per profiled request whose innermost
program span is ``gpar.fit.launch`` or ``gpar.fit.read``
(``h100bench.lib.spans``): the card waiting on the scan loop's round trips,
a body's launch (a CUDA-graph replay) and the host read that waits on it.
The two are read together: where the host waits, in the launch or in the
read's copy, moves with the depth of the device's queue and not with the
work, so either alone halves or doubles between runs of the same work."""

from h100bench.lib import spans

NAMES = ("gpar.fit.launch", "gpar.fit.read")


def read(ctx, variant):
    if ctx.trace is None or not spans.program_spans(ctx.trace, NAMES[0]):
        return None
    idle = spans.self_idle_ns(ctx.trace)
    return spans.per_request_ms(sum(idle.get(name, 0) for name in NAMES), ctx)
