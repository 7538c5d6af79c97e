"""Device-idle time by program span (``h100bench/lib/spans.py``) and its
readers, on hand-made traces in ns.

Two profiled requests.  The first, (0, 100), has device operations at
(0, 10), (30, 40), (70, 75) and (90, 100), so it idles over (10, 30),
(40, 70) and (75, 90), and the program's spans ``gpar.fit`` (5, 80) with
``gpar.fit.launch`` (20, 35) and ``gpar.fit.read`` (50, 60) under it, then
``gpar.predict`` (80, 95) with ``gpar.predict.tail`` (80, 86), which starts
with it, and ``gpar.predict.summary`` (86, 88).  The gaps (10, 30) and (75, 90)
straddle span boundaries.  The second, (200, 230), runs (210, 220) on the
device under no program span: its 20 ns of idle are the benchmark's own.
"""

import pytest

from h100bench.lib import cell, spans
from h100bench.lib.profile import Trace

PROGRAM = [("gpar.fit", 5, 80), ("gpar.fit.launch", 20, 35), ("gpar.fit.read", 50, 60),
           ("gpar.predict", 80, 95), ("gpar.predict.tail", 80, 86),
           ("gpar.predict.summary", 86, 88)]
#: Each span's self idle, by hand.
SELF = {"gpar.fit": 10 + 10 + 10 + 5, "gpar.fit.launch": 10, "gpar.fit.read": 10,
        "gpar.predict": 2, "gpar.predict.tail": 6, "gpar.predict.summary": 2,
        spans.OUTSIDE: 20}


def trace(program=PROGRAM):
    t = Trace.__new__(Trace)
    t.spans = [("h100bench.request", 0, 100), ("h100bench.request", 200, 230)]
    t.device = [("k", 0, 10), ("k", 30, 40), ("k", 70, 75), ("k", 90, 100), ("k", 210, 220)]
    t.host = [*program, ("aten::mul", 12, 14), ("cudaGraphLaunch", 21, 23)]
    return t


def context(tr):
    return cell.Context(trace=tr, traced=[{}, {}])


@pytest.mark.parametrize("program, want", [
    (PROGRAM, SELF),
    ([], {spans.OUTSIDE: 65 + 20}),
    ([("gpar.fit", 0, 230)], {"gpar.fit": 85}),
], ids=["nested", "no-program-spans", "one-span-over-both"])
def test_self_idle_sums_to_the_union_idle(program, want):
    tr = trace(program)
    got = spans.self_idle_ns(tr)
    assert got == want
    assert sum(got.values()) == pytest.approx(1e9 * (tr.window_s() - tr.busy_s()), abs=1e-6)


def test_idle_inside_a_span_counts_its_children():
    tr = trace()
    assert spans.idle_inside_ns(tr, "gpar.fit") == 35 + 10 + 10
    assert spans.idle_inside_ns(tr, "gpar.predict") == 2 + 6 + 2
    assert spans.idle_inside_ns(tr, "gpar.fit.capture") is None


@pytest.mark.parametrize("stem, want_ns", [
    ("fit_idle_ms", 55), ("launch_idle_ms", 10 + 10), ("predict_ms", 15), ("tail_idle_ms", 6),
])
def test_readers(stem, want_ns):
    read, _ = cell.reader(f"{stem}.fit.sparse")
    assert read(context(trace()), "fit.sparse") == pytest.approx(want_ns / 1e6 / 2)
    # No profiled requests, or a program without spans (the parent's): no number.
    assert read(cell.Context(trace=None, traced=[]), "fit.sparse") is None
    assert read(context(trace([])), "fit.sparse") is None
