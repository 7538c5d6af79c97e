"""The exchange-rate GPAR of the paper (``examples/exchange.py``: RQ kernels,
outputs with gaps imputed, ``replace=False``) against the benchmark's plain
reference, ``h100bench/reference/gpar_ancestral.py``, on the CPU in
float64.

p = 4 outputs over n = 48 rows, two of them missing over a stretch each,
t = 12 test inputs and S = 6 draws, from seeded random hyperparameters set
through the estimator's variables: each layer's NLL at them (the fit's
start) and at the fitted ones, and the predictive mean and bounds from the
same normals.  The tolerance, 1e-9 of the outputs' standard deviation and
of a nat, is rounding: the program masks a bucket of rows where the
reference factors the observed rows alone, so the two sum in other orders
(they agree to about 1e-14 here).  The reference with the posterior mean
fed forward (``replace=True``) misses it, so the comparison tells the two
modes apart."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gpar_torch  # noqa: E402
from gpar_torch import GPARRegressor  # noqa: E402
from h100bench.reference import gpar_ancestral as R  # noqa: E402

from .torch_cases import chain_data  # noqa: E402

P, N, T, S = 4, 48, 12, 6
TOL = 1e-9
GAPS = {1: (0.2, 0.4), 2: (0.5, 0.7)}
EXCHANGE = dict(scale=0.1, linear=True, linear_scale=10.0, nonlinear=True, nonlinear_scale=1.0,
                rq=True, noise=0.01, impute=True, replace=False, normalise_y=True, x_ind=None)


def gapped_data():
    x, y, x_test = chain_data(n=N, p=P, seed=0, n_test=T)
    frac = (x - x.min()) / (x.max() - x.min())
    for col, (lo, hi) in GAPS.items():
        y[(frac >= lo) & (frac < hi), col] = np.nan
    return x, y, x_test


@pytest.fixture(params=["cached", "uncached-chunked"])
def served(request, monkeypatch):
    """A model fitted for 3 iterations from seeded random latents, then
    ``predict`` from given normals; uncached, its factors are computed in
    the tail (the 4400-row cell's route) and its samples run in chunks."""
    if request.param == "uncached-chunked":
        monkeypatch.setattr(gpar_torch.config, "posterior_cache", False)
        monkeypatch.setattr(gpar_torch.config, "predict_sample_chunk", 4)
    x, y, x_test = gapped_data()
    reg = GPARRegressor(**EXCHANGE, device="cpu", dtype=torch.float64)
    reg.condition(x, y)
    reg._ensure_vars(P)
    snap, rng = reg.vs.snapshot(), np.random.default_rng(1)
    reg.load_latents({k: snap[k] + 0.3 * rng.standard_normal(np.shape(snap[k]))
                      for k in reg.vs.names})
    start = {k: np.asarray(v, float).reshape(-1).tolist() for k, v in reg.get_variables().items()}
    reg.fit(x, y, iters=3)
    assert reg.precompute() is (request.param == "cached")
    normals = np.random.default_rng(2).standard_normal((P, S, T))
    got = reg.predict(x_test, num_samples=S, credible_bounds=True, normals=normals)
    hypers = {k: np.asarray(v, float).reshape(-1).tolist() for k, v in reg.get_variables().items()}
    return reg, got, start, hypers, (x, y, x_test, torch.as_tensor(normals))


def reference(served, replace=False):
    reg, _, start, hypers, (x, y, x_test, normals) = served
    eps = gpar_torch.config.epsilon
    yn, mean, std = R.normalise(torch.as_tensor(y, dtype=torch.float64))
    c = R.condition(hypers, torch.as_tensor(x)[:, None], yn, None, eps, start_hypers=start)
    out = R.predict(c["layers"], torch.as_tensor(x_test)[:, None], normals, mean, std, eps,
                    replace=replace)
    return c, [a.numpy() for a in out], std.numpy()


def test_layer_nlls_agree_with_the_reference(served):
    c, _, _ = reference(served)
    rep = served[0].last_fit_report
    np.testing.assert_allclose(rep["layer_nll0"], c["nll0"], rtol=0, atol=TOL)
    np.testing.assert_allclose(rep["layer_nll"], c["nll"], rtol=0, atol=TOL)
    # The fit moved every layer from its random start.
    assert all(a < b for a, b in zip(c["nll"], c["nll0"]))


def test_predictive_agrees_with_the_reference(served):
    _, want, std = reference(served)
    for g, w in zip(served[1], want):
        assert np.max(np.abs(g - w) / std) < TOL
    rep = served[0].last_predict_report
    assert rep["sample_factor_batches"] > 0 and rep["sample_factor_escalations"] == 0


def test_the_mean_fed_forward_misses_the_tolerance(served):
    _, want, std = reference(served, replace=True)
    gap = max(np.max(np.abs(g - w) / std) for g, w in zip(served[1], want))
    assert gap > 1e3 * TOL


def test_sampling_factor_counters():
    # One call over three matrices: one that holds at the first rung, one
    # that needs the second (an eigenvalue of -5e2 jitters), one that no
    # rung repairs (the clamped eigendecomposition).  Every rung is read
    # once, as the ladder reads it anyway.
    from gpar_torch.ops import linalg

    eps = linalg.resolve_epsilon(torch.float64)
    K = torch.stack([torch.eye(2, dtype=torch.float64),
                     torch.diag(torch.tensor([1.0, -5e2 * eps], dtype=torch.float64)),
                     torch.diag(torch.tensor([1.0, -1.0], dtype=torch.float64))])
    linalg.reset_counters()
    F = linalg.psd_sample_factor_batched(K)
    assert torch.isfinite(F).all()
    rungs = 2 + len(gpar_torch.config.cholesky_retry_factors)
    assert linalg.counters() == {"sample_factor_batches": 1, "sample_factor_rungs": rungs,
                                 "sample_factor_escalations": 2, "sample_factor_eigh": 1}
    linalg.reset_counters()
    assert set(linalg.counters().values()) == {0}
