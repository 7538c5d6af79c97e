"""The ``predict_ancestral`` entry and its configuration at a tiny size on the
CPU: a whole run with the gaps in range comes out correct, and false with
each of the entry's faults planted; its readers on hand-made traces and
records; the work counts behind ``mfu`` and ``gram_roofline`` against hand
counts (``test_h100bench_work.py``'s conventions); and the reference's
independence of the program."""

import contextlib
import json

import numpy as np
import pytest

from h100bench.lib import cell, faults
from h100bench.lib import work_ancestral as WA
from h100bench.lib.profile import Trace
from h100bench.tests.test_h100bench_imports import FORBIDDEN, imported_tops
from h100bench.tests.tiny import BENCH, config

NAME = "exchange-rq-p13-n4k-f64"
CELL = f"{NAME}.serve_ancestral"


def tiny_spec():
    """p = 4, outputs 1 and 2 with gaps, 10 draws, 40-60 test inputs."""
    cfg = config(NAME, p=4, samples=10, gaps={"1": [0.2, 0.4], "2": [0.5, 0.7]})
    traffic = json.loads((BENCH / "traffic" / "serve_ancestral.json").read_text())
    traffic.update(size_range=[40, 60], checked_requests=3)
    return cell.Spec(CELL, cfg=cfg, traffic=traffic)


@pytest.mark.parametrize("fault", [None, *cell.Spec(CELL).entry.FAULTS])
def test_the_run_is_correct_and_each_fault_is_not(fault):
    spec = tiny_spec()
    with faults.plant(fault) if fault else contextlib.nullcontext():
        result, rows = cell.run(spec, 2**31 + 977, 0.5, False, device="cpu", log=lambda s: None)
    assert result["correct"] is (fault is None), rows
    (name, value, limit), = rows
    assert name == "pred_gap" and (value > limit) is (fault is not None)


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card():
    # As test_h100bench_control.py for the other cells: p = 4 with two gaps,
    # 2000 rows, 20 draws; the program correct, the float32 reference in its
    # place not.  Run on a machine with an H100:
    #     python -m pytest h100bench/tests/test_h100bench_ancestral.py -m cuda
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's test sizes there")
    cfg = config(NAME, p=4, serve_rows=2000, samples=20, gaps={"1": [0.2, 0.4], "2": [0.5, 0.7]})
    spec = cell.Spec(CELL, cfg=cfg)
    result, rows = cell.run(spec, 4242, 3.0, False, device="cuda", log=print, control=True)
    assert result["correct"], rows
    assert result["control"]["pred_gap"] > spec.limits["pred_gap"], result["control"]


def test_gaps_fall_on_their_stretch_and_past_p_are_left_out():
    from h100bench.entries.predict_ancestral import with_gaps

    x = np.linspace(0.0, 10.0, 101)
    y = np.ones((101, 3))
    got = with_gaps({"gaps": {"1": [0.2, 0.4], "9": [0.0, 1.0]}}, x, y)
    assert np.isnan(got[:, 1]).sum() == 20 and np.isnan(got[20:40, 1]).all()
    assert not np.isnan(got[:, [0, 2]]).any() and not np.isnan(y).any()


def test_the_configuration_states_its_gaps_and_model():
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    assert cfg["model"]["rq"] and not cfg["model"]["replace"] and cfg["model"]["impute"]
    assert cfg["p"] == 13 and cfg["serve_rows"] == 4400 and cfg["samples"] == 100
    assert {int(k) for k in cfg["gaps"]} == {9, 10, 11}


# A hand-made trace of one profiled predict (ns), (0, 100): device operations
# at (0, 10), (30, 60) and (80, 100); the program's spans nest as the
# per-sample tail's: the layer's factors (5, 25), then a chunk (25, 90) with
# its sampling factor (60, 75).  Idle: (10, 30) and (60, 80).
PROGRAM = [("gpar.predict", 0, 100), ("gpar.predict.tail", 2, 95),
           ("gpar.predict.layer_factors", 5, 25), ("gpar.predict.chunk", 25, 90),
           ("gpar.predict.sample_factor", 60, 75)]


def trace(program=PROGRAM):
    t = Trace.__new__(Trace)
    t.spans = [("h100bench.request", 0, 100)]
    t.device = [("k", 0, 10), ("k", 30, 60), ("k", 80, 100)]
    t.host = list(program)
    return t


@pytest.mark.parametrize("stem, want_ns", [
    ("layer_factors_idle_ms", 15), ("sample_factor_idle_ms", 15), ("tail_idle_ms", 40),
])
def test_span_readers(stem, want_ns):
    read, variant = cell.reader(f"{stem}.serve.exchange")
    assert read(cell.Context(trace=trace(), traced=[{}]), variant) == pytest.approx(want_ns / 1e6)
    # A program without the spans (the parent's), or no trace: no number.
    assert read(cell.Context(trace=trace([]), traced=[{}]), variant) is None
    assert read(cell.Context(trace=None, traced=[]), variant) is None


def test_sample_escalations_reads_the_report():
    read, variant = cell.reader("sample_escalations.serve.exchange")
    recs = [{"predict_report": {"sample_factor_escalations": k}} for k in (0, 3)]
    assert read(cell.Context(records=recs), variant) == 1.5
    assert read(cell.Context(records=[{"wall_s": 1.0}]), variant) is None  # no report


SZ = {"n": 10, "observed": [10, 8], "m": 1, "M": 0, "p": 2, "itemsize": 8}


def test_layer_factors_by_hand():
    # Layer 1 on its 8 observed rows of 10: RQ on x (1), linear and RQ on y0
    # (1 each): 2 * 3 + 12 + 1 = 19 operations per Gram element; the
    # observed Gram needs 8 * 9 / 2 = 36 elements, the gap rows' 2 * 8 = 16.
    # A Cholesky of order 8, two solves, three O(n) terms, and the mean at
    # the 2 gap rows.
    ops, _ = WA.layer_factors(1, SZ)
    assert ops == pytest.approx(19 * (36 + 16) + 8**3 / 3 + 2 * 8**2 + 3 * 8 + 2 * 2 * 8)
    # Layer 0, no gap: RQ on x alone, 2 + 4 + 1 = 7 per element of 55.
    ops, _ = WA.layer_factors(0, SZ)
    assert ops == pytest.approx(7 * 55 + 10**3 / 3 + 2 * 10**2 + 3 * 10)


def test_layer_samples_by_hand():
    # Layer 0 at t = 3 test inputs, S = 2 draws: per sample the cross-
    # covariance 10 x 3 and the test Gram's 6 elements at 7, the mean 2 n t,
    # the solve n^2 t, half of V^T V t^2 n, a Cholesky t^3 / 3, the draw
    # t^2 and 3 t.
    t, n = 3, 10
    per = 7 * (n * t + 6) + 2 * n * t + n**2 * t + t**2 * n + t**3 / 3 + t**2 + 3 * t
    ops, bound = WA.layer_samples(0, SZ, t, 2)
    assert ops == pytest.approx(2 * per)
    # The Grams' bound: the batched cross-covariance with the training rows
    # shared, and the batched test Gram.
    want = (WA.gram_bound_ms(["rq"], [1], n, t, 8, batch=2, shared="left")[0]
            + WA.gram_bound_ms(["rq"], [1], t, t, 8, batch=2)[0])
    assert bound == pytest.approx(want)


def test_predict_work_sums_factors_and_samples():
    ops, bound = WA.predict_work(SZ, 3, 2)
    parts = [WA.layer_factors(i, SZ) for i in range(2)] + [WA.layer_samples(i, SZ, 3, 2)
                                                           for i in range(2)]
    assert ops == pytest.approx(sum(a for a, _ in parts))
    assert bound == pytest.approx(sum(b for _, b in parts))


def test_reference_imports_neither_jax_nor_the_port():
    path = BENCH / "reference" / "gpar_ancestral.py"
    assert not imported_tops(path) & (FORBIDDEN | {"gpar_torch", "h100bench"})
