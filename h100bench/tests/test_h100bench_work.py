"""The work counts behind ``mfu`` and ``gram_roofline`` against hand counts
at a tiny size (``h100bench/lib/work.py``'s conventions)."""

import pytest

from h100bench.lib import work as W

SPARSE = {"n": 10, "m": 1, "M": 4, "p": 2, "itemsize": 4}
DENSE = dict(SPARSE, M=0)


def test_layer_terms():
    assert W.layer_terms(0, 1) == (["rbf"], [1])
    assert W.layer_terms(3, 1) == (["rbf", "lin", "rbf"], [1, 3, 3])


def test_sparse_layer_zero_by_hand():
    # EQ on one input: 2 * 1 + 4 + 1 = 7 operations per Gram element;
    # Kmm needs 4 * 5 / 2 = 10 elements, Kmn 4 * 10 = 40.
    grams = 7 * (10 + 40)
    # Two Cholesky of order 4, the solve and the symmetric product against
    # 10 rows, six O(M n) terms, three solves of order 4, six O(n) terms.
    panel = 2 * 4**3 / 3 + 2 * 4**2 * 10 + 6 * 4 * 10 + 3 * 4**2 + 6 * 10
    value, _ = W._layer_eval(0, SPARSE, grad=False)
    assert value == pytest.approx(panel + grams)
    # The backward: twice the panel and the Gram backward, 1 + 6 + 4 = 11
    # operations per element of Kmm (16) and Kmn (40).
    both, _ = W._layer_eval(0, SPARSE, grad=True)
    assert both == pytest.approx(3 * panel + grams + 11 * (16 + 40))


def test_dense_layer_one_by_hand():
    # Layer 1: EQ on x (1), linear on y0 (1), EQ on y0 (1): 2 * 3 + 12 + 1
    # = 19 operations per element; K needs 10 * 11 / 2 = 55 elements.
    n = 10
    value, _ = W._layer_eval(1, DENSE, grad=False)
    assert value == pytest.approx(n**3 / 3 + 2 * n**2 + 3 * n + 19 * 55)
    # The gradient through K^-1 (2 n^3 / 3 + n^2) and the Gram backward:
    # 1 + (6 + 4) + (4 + 1) + (6 + 4) = 26 per element of the 100, plus the
    # linear term's 2 n.
    both, _ = W._layer_eval(1, DENSE, grad=True)
    assert both == pytest.approx(value + 2 * n**3 / 3 + n**2 + 26 * 100 + 2 * n)


def test_predict_by_hand():
    # Sparse layer 0 at t = 3 test inputs, S = 2 draws: Kmt 4 x 3 and the
    # test Gram (6 elements) at 7; the mean 2 M t; two solves M^2 t; two
    # symmetric products t^2 M; a Cholesky t^3 / 3; the draws S t^2; 3 S t.
    t, S, M = 3, 2, 4
    want = 7 * (12 + 6) + 2 * M * t + 2 * M**2 * t + 2 * t**2 * M + t**3 / 3 + S * t**2 + 3 * S * t
    got = W._predict_layer(0, SPARSE, t, S)[0]
    assert got == pytest.approx(want)


def test_fit_work_counts_the_report():
    report = {"layer_iters": [2, 3], "linesearch_episodes": 1, "linesearch_trials": 4}
    g = [W._layer_eval(i, SPARSE, True)[0] for i in range(2)]
    v = [W._layer_eval(i, SPARSE, False)[0] for i in range(2)]
    want = 3 * g[0] + 4 * g[1] + v[0] + v[1] + (g[0] + g[1]) / 2 + 4 * (v[0] + v[1]) / 2
    assert W.fit_work(SPARSE, report)[0] == pytest.approx(want)
    assert W.evaluations(report) == 2 + 5 + 4


def test_gram_bound_by_hand():
    # 1000 x 2000 float32 Gram of one EQ term of width 1: 4 (2e6 + 3000 + 3)
    # bytes at 3.35e12 B/s against 2e6 * 7 operations at 67e12.
    ms, by = W.gram_bound_ms(["rbf"], [1], 1000, 2000, 4)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 4 * (2e6 + 3000 + 3) / 3.35e12)
    ms, by = W.gram_bwd_bound_ms(["rbf"], [1], 1000, 2000, 4)
    assert ms == pytest.approx(1e3 * max(4 * (2e6 + 6000 + 6) / 3.35e12, 2e6 * 11 / 67e12))
