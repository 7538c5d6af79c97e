"""The reader of ``tail_replay_share`` (``h100bench/layer_metrics/
tail_replay_share.py``) on a hand-made trace in ns: four profiled predicts,
two replayed with no repair, one replayed and repaired, one eager."""

import pytest

from h100bench.lib import cell
from h100bench.lib.profile import Trace

PREDICTS = [
    # A replayed predict: capture (a cache miss), then the replay.
    ("gpar.predict", 0, 100), ("gpar.predict.tail", 10, 90), ("gpar.predict.capture", 12, 60),
    ("gpar.predict.replay", 61, 80),
    # A replayed predict, a cache hit.
    ("gpar.predict", 100, 200), ("gpar.predict.tail", 110, 190), ("gpar.predict.replay", 111, 150),
    # A replay whose layer was repaired.
    ("gpar.predict", 200, 300), ("gpar.predict.tail", 210, 290), ("gpar.predict.replay", 211, 230),
    ("gpar.predict.repair", 231, 260),
    # An eager tail.
    ("gpar.predict", 300, 400), ("gpar.predict.tail", 310, 390),
]


def trace(program=PREDICTS):
    t = Trace.__new__(Trace)
    t.spans = [("h100bench.request", 100 * k, 100 * k + 100) for k in range(4)]
    t.device = [("k", 100 * k + 20, 100 * k + 30) for k in range(4)]
    t.host = [*program, ("cudaGraphLaunch", 62, 63)]
    return t


def context(tr):
    return cell.Context(trace=tr, traced=[{}] * 4)


@pytest.mark.parametrize("program, want", [
    (PREDICTS, 50.0),
    ([r for r in PREDICTS if r[0] != "gpar.predict.repair"], 75.0),
    ([r for r in PREDICTS if r[0] not in ("gpar.predict.replay", "gpar.predict.repair")], 0.0),
], ids=["mixed", "no-repair", "all-eager"])
def test_tail_replay_share(program, want):
    read, variant = cell.reader("tail_replay_share.serve.sparse")
    assert variant == "serve.sparse"
    assert read(context(trace(program)), variant) == pytest.approx(want)


def test_tail_replay_share_without_a_trace_or_a_tail_graph(monkeypatch):
    read, _ = cell.reader("tail_replay_share.serve.dense")
    assert read(cell.Context(trace=None, traced=[]), "serve.dense") is None
    assert read(context(trace([])), "serve.dense") is None  # no tail span
    # A program without the tail graph (the parent's) marks no replay: no number.
    import gpar_torch.models.graphs as graphs

    monkeypatch.delattr(graphs, "graphed_tail")
    assert read(context(trace()), "serve.dense") is None
