"""The spans of gpar_torch's fit and predict (``gpar_torch/utils/spans.py``)
on ``torch.profiler``'s timeline: their names and nesting, their counts
against the fit's report, and that nothing is recorded with no profiler.

One tiny sparse ``fit_predict`` on the CPU (p = 3, 40 rows, 8 inducing
points) under the profiler serves the CPU tests; a fit whose first jitter
rung fails in some layers has a repair span for each layer run again, on
the CPU and on the card.  The card tests check the
graphed fit: a capture span on a graph-cache miss only, a launch span per
graph replay, and no span among the card's operations; and the tail
graphs of the cached and the uncached predict: their capture, replay and
repair spans inside ``gpar.predict.tail``, on the card and, with the
graph stood in for by eager runs, on the CPU.  This file imports
neither JAX nor ``gpar_tpu``, so on a card it runs as::

    python -m pytest --noconftest tests/test_torch_spans.py
"""

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gpar_torch import GPARRegressor  # noqa: E402
from gpar_torch.utils import spans  # noqa: E402

from .torch_cases import bench_kwargs, chain_data  # noqa: E402

P, N, NT, S, ITERS = 3, 40, 12, 6, 3


def _spans(prof):
    """The ``gpar.*`` host spans of a profile as ``(name, start_ns, end_ns)``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("gpar.") and e.device_type() == torch.autograd.DeviceType.CPU:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda r: r[1])


def _named(rows, name):
    return [r for r in rows if r[0] == name]


@pytest.fixture(scope="module")
def traced():
    """A profiled ``fit_predict``: its spans, the fit's report and the
    fitted estimator."""
    x, y, x_test = chain_data(n=N, p=P, seed=0, n_test=NT)
    reg = GPARRegressor(**bench_kwargs(n_ind=8), device="cpu", dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reg.fit_predict(x, y, x_test, iters=ITERS, num_samples=S)
    return _spans(prof), reg.last_fit_report, reg, x_test


@pytest.mark.parametrize("child, parent", [
    ("gpar.condition", "gpar.fit"),
    ("gpar.fit.prepare", "gpar.fit"),
    ("gpar.fit.launch", "gpar.fit"),
    ("gpar.fit.read", "gpar.fit"),
    ("gpar.predict.tail", "gpar.predict"),
    ("gpar.predict.summary", "gpar.predict"),
    ("gpar.predict.read", "gpar.predict"),
])
def test_spans_nest_inside_their_entry_span(traced, child, parent):
    rows = traced[0]
    outer = _named(rows, parent)
    inner = _named(rows, child)
    assert len(outer) == 1 and inner
    _, a, b = outer[0]
    assert all(a <= s and e <= b for _, s, e in inner)


def test_fit_and_predict_spans_do_not_overlap(traced):
    (fit,), (predict,) = _named(traced[0], "gpar.fit"), _named(traced[0], "gpar.predict")
    assert fit[2] <= predict[1]


def test_read_and_launch_spans_count_as_the_report(traced):
    # Each host read is one read span.  Each body run is one launch span:
    # per layer its start and finish, per L-BFGS iteration its step and
    # commit, and per backtracking episode its trials and one more step.
    rows, rep = traced[0], traced[1]
    assert len(_named(rows, "gpar.fit.read")) == rep["host_syncs"]
    iterations = rep["host_syncs"] - 1 - rep["linesearch_episodes"] - rep["linesearch_trials"]
    bodies = 2 * P + 2 * iterations + rep["linesearch_trials"] + rep["linesearch_episodes"]
    assert len(_named(rows, "gpar.fit.launch")) == bodies
    assert not _named(rows, "gpar.fit.capture")  # eager on the CPU: nothing captured


@pytest.mark.parametrize("route, model", [
    (dict(fix=False), {}),
    (dict(fused="batched"), dict(x_ind=None, replace=False)),
    (dict(fused=False), {}),
    (dict(trace=True), {}),
    (dict(greedy=True), {}),
], ids=["joint", "batched-dense", "per-layer", "trace", "greedy"])
def test_read_spans_count_as_host_syncs_on_every_route(route, model):
    # Every host read of a fit, on any route, is one read span inside
    # ``gpar.fit``; the greedy search's reads count in its own report.
    x, y, _ = chain_data(n=N, p=2, seed=0, n_test=NT)
    kw = {**bench_kwargs(n_ind=8), **model}
    reg = GPARRegressor(**kw, compat=False, device="cpu", dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reg.fit(x, y, iters=2, **route)
    rows = _spans(prof)
    syncs = reg.last_fit_report["host_syncs"]
    if route.get("greedy"):
        syncs += sum(pos["host_syncs"] for pos in reg.last_greedy_report["positions"])
    reads = _named(rows, "gpar.fit.read")
    assert len(reads) == syncs > 0
    (_, a, b), = _named(rows, "gpar.fit")
    assert all(a <= s and e <= b for _, s, e in reads)


def test_no_profiler_no_record_function(traced, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans, "_RecordFunctionFast", Counting)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("gpar.fit") is spans.span("gpar.predict")
    reg, x_test = traced[2], traced[3]
    reg.predict(x_test, num_samples=S)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("gpar.fit"):
            pass
    assert entered == ["gpar.fit"]


def test_cached_predict_spans_its_tail_and_no_fit(traced):
    reg, x_test = traced[2], traced[3]
    assert reg.precompute()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reg.predict(x_test, num_samples=S)
    names = {name for name, _, _ in _spans(prof)}
    assert {"gpar.predict", "gpar.predict.tail", "gpar.predict.read"} <= names
    assert not [n for n in names if n.startswith("gpar.fit")]


@pytest.fixture(scope="module", params=["cached", "uncached"])
def ancestral(request):
    """A profiled ``replace=False`` predict of a dense RQ model with a gap
    in one output (the exchange-rate configuration's route) in chunks of 4
    of its 6 samples: its spans and its report.  Uncached, each layer's
    factors are computed in the tail."""
    import gpar_torch

    x, y, x_test = chain_data(n=N, p=P, seed=0, n_test=NT)
    y[10:20, 1] = float("nan")
    reg = GPARRegressor(**dict(bench_kwargs(), x_ind=None, rq=True, replace=False),
                        device="cpu", dtype=torch.float64)
    reg.fit(x, y, iters=ITERS)
    saved = gpar_torch.config.posterior_cache, gpar_torch.config.predict_sample_chunk
    gpar_torch.config.posterior_cache = request.param == "cached"
    gpar_torch.config.predict_sample_chunk = 4
    try:
        assert reg.precompute() is (request.param == "cached")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            reg.predict(x_test, num_samples=S)
    finally:
        gpar_torch.config.posterior_cache, gpar_torch.config.predict_sample_chunk = saved
    return _spans(prof), reg.last_predict_report


def test_ancestral_spans_nest_inside_the_tail(ancestral):
    # p layer_factors spans, a chunk span per layer and chunk of samples,
    # one sample_factor span inside each chunk, all inside the tail.
    rows, report = ancestral
    (_, a, b), = _named(rows, "gpar.predict.tail")
    chunks = _named(rows, "gpar.predict.chunk")
    factors = _named(rows, "gpar.predict.sample_factor")
    names = ("gpar.predict.layer_factors", "gpar.predict.chunk", "gpar.predict.sample_factor")
    assert all(a <= s and e <= b for n, s, e in rows if n in names)
    assert len(_named(rows, "gpar.predict.layer_factors")) == P
    assert len(chunks) == P * -(-S // 4) == report["sample_factor_batches"]
    assert [sum(c0 <= s and e <= c1 for _, s, e in factors) for _, c0, c1 in chunks] == \
        [1] * len(chunks)


def test_ancestral_report_counts_the_batches(ancestral):
    report = ancestral[1]
    assert report["sample_chunk"] == 4
    assert report["sample_factor_batches"] == report["sample_factor_rungs"] == P * 2
    assert report["sample_factor_escalations"] == report["sample_factor_eigh"] == 0


@pytest.mark.cuda
def test_cuda_graphed_fit_spans_match_its_report():
    # A graph-cache miss then a hit: a capture span on the miss alone, a
    # launch span per graph replay, a read span per host read; no span
    # reaches the card's timeline.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphed fit has no CPU mode)")
    from gpar_torch.models import graphs

    x, y, x_test = chain_data(n=N, p=P, seed=0, n_test=NT)
    graphs.clear_cache()
    try:
        captures = []
        for _ in range(2):
            reg = GPARRegressor(**bench_kwargs(n_ind=8), device="cuda", dtype=torch.float64)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                reg.fit_predict(x, y, x_test, iters=ITERS, num_samples=S)
                torch.cuda.synchronize()
            rows, rep = _spans(prof), reg.last_fit_report
            assert rep["cuda_graphs"] and rep["graph_replays"] > 0
            assert len(_named(rows, "gpar.fit.launch")) == rep["graph_replays"]
            assert len(_named(rows, "gpar.fit.read")) == rep["host_syncs"]
            captures.append(len(_named(rows, "gpar.fit.capture")))
            cuda = torch.autograd.DeviceType.CUDA
            leaked = {e.name() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == cuda and e.name().startswith("gpar.")}
            assert not leaked
        assert captures == [1, 0]
    finally:
        graphs.clear_cache()


def _repair_spans(device, jitter):
    """The spans and report of a sparse fit at the first jitter ``jitter``
    (-0.3 fails the first rung of some layers' factorisations)."""
    import gpar_torch

    x, y, _ = chain_data(n=N, p=P, seed=0, n_test=NT)
    reg = GPARRegressor(**bench_kwargs(n_ind=8), device=device, dtype=torch.float64)
    eps = gpar_torch.config.epsilon
    gpar_torch.config.epsilon = eps if jitter is None else jitter
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    try:
        with profile(activities=activities) as prof:
            reg.fit(x, y, iters=ITERS)
    finally:
        gpar_torch.config.epsilon = eps
    return _spans(prof), reg.last_fit_report


def _check_repair_spans(rows, rep, repaired):
    # A repair span per layer run again, and only then; each inside the fit,
    # holding read spans and no launch span; every read still a host sync.
    repairs = _named(rows, "gpar.fit.repair")
    assert (len(repairs) > 0) == repaired and len(repairs) == rep["ladder_repairs"]
    assert len(_named(rows, "gpar.fit.read")) == rep["host_syncs"]
    (_, a, b), = _named(rows, "gpar.fit")
    for _, s, e in repairs:
        assert a <= s and e <= b
        inside = [n for n, s2, e2 in rows if s <= s2 and e2 <= e]
        assert "gpar.fit.read" in inside and "gpar.fit.launch" not in inside


@pytest.mark.parametrize("jitter", [None, -0.3], ids=["holds", "repaired"])
def test_repair_spans_count_the_layers_run_again(jitter):
    rows, rep = _repair_spans("cpu", jitter)
    _check_repair_spans(rows, rep, jitter is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("jitter", [None, -0.3], ids=["holds", "repaired"])
def test_cuda_repair_spans_count_the_layers_run_again(jitter):
    # On the card the repair runs eagerly between replays: launch spans still
    # count the graph replays alone.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphed fit has no CPU mode)")
    from gpar_torch.models import graphs

    graphs.clear_cache()
    try:
        rows, rep = _repair_spans("cuda", jitter)
    finally:
        graphs.clear_cache()
    assert rep["cuda_graphs"] and len(_named(rows, "gpar.fit.launch")) == rep["graph_replays"]
    _check_repair_spans(rows, rep, jitter is not None)


def _tail_graph_spans(device, route):
    """Three predicts of a fitted sparse model on ``route`` (``"cached"``
    after ``precompute()``, or ``"uncached"`` with the factor cache off),
    the second at the first's key, the third a forced failure (duplicate
    test inputs, layer 1's noise weighted down to nothing, the jitter
    lowered to -1e-4: another key): each predict's count of capture, replay
    and repair spans, each span checked to lie inside ``gpar.predict.tail``."""
    import numpy as np

    import gpar_torch
    from gpar_torch.models import graphs

    x, y, x_test = chain_data(n=N, p=P, seed=0, n_test=NT)
    dup, w = x_test.copy(), np.ones((NT, P))
    dup[:4], w[:, 1] = dup[0], 1e30
    names = ("gpar.predict.capture", "gpar.predict.replay", "gpar.predict.repair")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    graphs.clear_cache()
    eps, cache, counts = gpar_torch.config.epsilon, gpar_torch.config.posterior_cache, []
    try:
        reg = GPARRegressor(**bench_kwargs(n_ind=8), device=device, dtype=torch.float64)
        reg.fit(x, y, iters=ITERS)
        gpar_torch.config.posterior_cache = route == "cached"
        assert reg.precompute() is (route == "cached")
        for xt, wt, jitter in ((x_test, None, eps), (x_test, None, eps), (dup, w, -1e-4)):
            gpar_torch.config.epsilon = jitter
            with profile(activities=activities) as prof:
                reg.predict(xt, wt, num_samples=S)
                if device == "cuda":
                    torch.cuda.synchronize()
            rows = _spans(prof)
            (_, a, b), = _named(rows, "gpar.predict.tail")
            assert all(a <= s and e <= b for n, s, e in rows if n in names)
            counts.append(tuple(len(_named(rows, n)) for n in names))
    finally:
        gpar_torch.config.epsilon, gpar_torch.config.posterior_cache = eps, cache
        graphs.clear_cache()
    return counts


class _EagerGraphs:
    """Stands in for ``graphs.GraphedStep`` off the card: the capture span
    on a miss, then every body run eagerly."""

    capture_s = 0.0

    def __init__(self, step):
        with spans.span(step.CAPTURE_SPAN):
            self.run = lambda name: getattr(step, name)()

    def __call__(self, name):
        return self.run(name)


@pytest.mark.parametrize("route", ["cached", "uncached"])
def test_tail_graph_spans_nest_inside_the_tail(route, monkeypatch):
    # The graph's route on the CPU, its capture and replay stood in for by
    # eager runs: the cache, its keys, the one read and the repair as on
    # the card; a repair span on the forced failure alone.
    from gpar_torch.models import graphs

    monkeypatch.setattr(graphs, "on_card", lambda device: True)
    monkeypatch.setattr(graphs, "GraphedStep", _EagerGraphs)
    monkeypatch.setattr(graphs, "_reserved", lambda device: 0)
    monkeypatch.setattr(graphs, "_budget", lambda device: float("inf"))
    assert _tail_graph_spans("cpu", route) == [(1, 1, 0), (0, 1, 0), (1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["cached", "uncached"])
def test_cuda_tail_graph_spans_nest_inside_the_tail(route):
    # Predicts on the card: a capture span on the tail graph's first predict
    # alone, a replay span in each, a repair span for the forced failure (a
    # layer repaired on the cached route, the whole eager tail on the
    # uncached one), all inside ``gpar.predict.tail``.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the tail graph has no CPU mode)")
    assert _tail_graph_spans("cuda", route) == [(1, 1, 0), (0, 1, 0), (1, 1, 1)]
