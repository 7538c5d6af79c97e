"""tail_replay_share: % of the profiled predicts whose ``gpar.predict.tail``
span holds a ``gpar.predict.replay`` span (the cached predictive tail
replayed as one CUDA graph) and no ``gpar.predict.repair`` span (no layer's
first rung of the sampling factor failed, so nothing ran eagerly after the
replay).  An eager tail reads 0.  None without a trace or a tail span, and
where the program has no tail graph (``gpar_torch.models.graphs`` without
``graphed_tail``), which never marks a replay."""

import importlib

from h100bench.lib import spans


def _has_tail_graph():
    try:
        graphs = importlib.import_module("gpar_torch.models.graphs")
    except ImportError:
        return False
    return hasattr(graphs, "graphed_tail")


def read(ctx, variant):
    if ctx.trace is None or not _has_tail_graph():
        return None
    tails = spans.program_spans(ctx.trace, "gpar.predict.tail")
    if not tails:
        return None
    replays = spans.program_spans(ctx.trace, "gpar.predict.replay")
    repairs = spans.program_spans(ctx.trace, "gpar.predict.repair")

    def holds(rows, a, b):
        return any(a <= s and e <= b for _, s, e in rows)

    clean = sum(holds(replays, a, b) and not holds(repairs, a, b) for _, a, b in tails)
    return 100.0 * clean / len(tails)
