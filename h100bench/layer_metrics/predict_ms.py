"""predict_ms: ms per profiled request in the program's ``gpar.predict``
spans, summed: the Monte-Carlo predictive from its inputs to the summary on
the host (the span ends with the copies that wait for the device's work);
conditioning, which runs in the fit, is left out."""

from h100bench.lib import spans


def read(ctx, variant):
    if ctx.trace is None:
        return None
    rows = spans.program_spans(ctx.trace, "gpar.predict")
    if not rows:
        return None
    return spans.per_request_ms(sum(b - a for _, a, b in rows), ctx)
