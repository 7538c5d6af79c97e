"""Greedy output ordering of gpar_torch (``fit(greedy=True)``) against
gpar_tpu's, float64, on the CPU.

A chain whose greedy order is known, [2, 0, 1] (column 2 a noisy signal,
column 0 a near-deterministic function of it, column 1 white noise; the
JAX package's own ``tests/test_greedy.py`` data), 48 rows, with and
without missing outputs, sparse (7 inducing points) and dense, at Markov
order None and 1.  Tolerances:

- the batched scorer's optimised NLLs per position (``_greedy_position_nlls``)
  against JAX's: 1e-8; the permutation (``_greedy_order``) identical;
- the batched scorer against the per-candidate oracle on the filtered rows
  (``_greedy_layer_nll``, the GP core): 1e-4, as JAX holds its own;
- after ``fit(greedy=True)``: the order identical, and at JAX's latents and
  order carried across (``load_latents(..., order=)``) ``predict``,
  ``logpdf`` (prior and posterior) and ``sample`` (posterior, a prior of
  the fitted width and a prior of another width) in the original columns,
  from JAX's standard normals: 1e-8;
- ``compat=True`` raises JAX's ``NotImplementedError``; a mismatched width
  raises JAX's ``ValueError`` and leaves the estimator as it was;
- neither package given ``iters``: the search runs 100 iterations at most
  and the fit 1000, in both;
- a second greedy fit on the same estimator scores as the first.

The search runs 8 L-BFGS iterations per candidate.  At the 10th, one
candidate of the dense full-data case (position 1, the signal given the
column that is twice it) reaches a covariance at the edge of positive
definiteness, where the port's jitter ladder escalates once and the two
packages' matrices, which differ by rounding, can take different rungs;
that candidate's NLL then parts from JAX's by 3 %.  The order is the same.
"""

import numpy as np
import pytest

from .test_torch_common import chain_data, close, jax, jax_chain_normals

from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.params.lbfgs import new_stats  # noqa: E402

N, NT, S, ITERS = 48, 10, 6, 8
TOL = 1e-8
X_IND = np.linspace(0.0, 10.0, 7)

#: Two configurations, each with and without missing outputs (which change
#: no shape, so JAX compiles one scorer per position and configuration):
#: the sparse model with the nonlinear output term at Markov order 1, and
#: the dense default at order None.  name -> (constructor arguments, missing)
SPARSE = dict(noise=0.1, compat=False, x_ind=X_IND, markov=1, nonlinear=True, linear_scale=10.0)
DENSE = dict(noise=0.1, compat=False)
CASES = {
    "sparse-markov1-missing": (SPARSE, True),
    "sparse-markov1-full": (SPARSE, False),
    "dense-missing": (DENSE, True),
    "dense-full": (DENSE, False),
}


def _data(missing=True, seed=5):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 10.0, N)
    a = np.sin(x) + 0.3 * rng.standard_normal(N)  # noisy signal
    b = 2.0 * a + 0.05 * rng.standard_normal(N)  # predictable given a
    c = rng.standard_normal(N)  # white noise
    y = np.stack([b, c, a], axis=1)
    if missing:  # a different row count per candidate
        y[rng.permutation(N)[:5], 0] = np.nan
        y[rng.permutation(N)[:9], 1] = np.nan
        y[rng.permutation(N)[:3], 2] = np.nan
    return x, y


def _position_inputs(reg, selected):
    """The scorer's inputs at a position, as ``_greedy_order`` forms them
    from the conditioned host copies."""
    y, w, x = reg._y_np, reg._w_np, reg._x_np
    remaining = [o for o in range(y.shape[1]) if o not in selected]
    masks = np.stack([~np.isnan(y[:, selected + [o]]).any(axis=1) for o in remaining])
    x_aug = np.concatenate([x, np.nan_to_num(y[:, selected])], axis=1)
    return x_aug, np.nan_to_num(y[:, remaining].T), w[:, remaining].T, masks


_SEARCH = {}


def _search(case):
    """JAX's greedy order of a case and its scorer's NLLs at every position
    (the estimators conditioned with the identity order)."""
    if case not in _SEARCH:
        kw, missing = CASES[case]
        x, y = _data(missing)
        rj = JReg(**kw)
        rj.condition(x, y)
        order = rj._greedy_order(ITERS)
        nlls = [rj._greedy_position_nlls(k, *_position_inputs(rj, list(order[:k])), ITERS, 1e-9, 10)
                for k in range(len(order))]
        _SEARCH[case] = (order, nlls)
    return _SEARCH[case]


def _conditioned_port(case):
    kw, missing = CASES[case]
    rt = TReg(**kw, device="cpu")
    rt.condition(*_data(missing))
    return rt


@pytest.mark.parametrize("case", list(CASES))
def test_position_nlls_match_jax(case):
    order, want = _search(case)
    rt = _conditioned_port(case)
    for k, nll_j in enumerate(want):
        stats = new_stats()
        got = rt._greedy_position_nlls(k, *_position_inputs(rt, list(order[:k])), ITERS, 1e-9, 10,
                                       stats=stats)
        assert got.shape == (len(order) - k,)
        close(got, nll_j, rtol=TOL)
        assert len(stats["iterations"]) == len(order) - k and stats["host_syncs"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_order_matches_jax(case):
    order, _ = _search(case)
    rt = _conditioned_port(case)
    got = rt._greedy_order(ITERS)
    np.testing.assert_array_equal(got, order)
    if CASES[case][1]:
        assert got.tolist() == [2, 0, 1]  # the known chain
    rep = rt.last_greedy_report
    assert rep["order"] == got.tolist() and len(rep["positions"]) == 3
    assert [len(p["nll"]) for p in rep["positions"]] == [3, 2, 1]


@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_batched_scores_match_per_candidate(model):
    # The masked batched scorer against the filtered-row oracle (the GP
    # core on each candidate's observed rows): identical initialisations,
    # masked rows exact zeros, so the trajectories agree to rounding.
    rng = np.random.default_rng(7)
    n = 40
    x = np.linspace(0.0, 6.0, n)
    y = np.stack([np.sin(x) + 0.1 * rng.standard_normal(n), rng.standard_normal(n)], axis=1)
    y[rng.permutation(n)[:6], 0] = np.nan
    y[rng.permutation(n)[:4], 1] = np.nan
    kw = dict(x_ind=np.linspace(0.0, 6.0, 7)) if model == "sparse" else {}
    rt = TReg(noise=0.1, compat=False, normalise_y=False, device="cpu", **kw)
    rt.condition(x, y)
    yn, wn, xn = rt._y_np, rt._w_np, rt._x_np
    masks = np.stack([~np.isnan(yn[:, o]) for o in range(2)])
    batched = rt._greedy_position_nlls(0, xn, np.nan_to_num(yn.T), wn.T, masks, 25, 1e-9, 10)
    for o in range(2):
        m = masks[o]
        single = rt._greedy_layer_nll(0, xn[m], yn[m, o], wn[m, o], 25, 1e-9, 10)
        np.testing.assert_allclose(batched[o], single, rtol=1e-4, atol=1e-4)


def test_empty_candidate_never_wins():
    # A candidate with no observed rows has an all-masked objective (NLL 0,
    # the best raw value): it must score -inf and come last.
    x, y = _data(missing=False)
    y[:, 1] = np.nan
    rt = TReg(noise=0.1, compat=False, normalise_y=False, device="cpu")
    rt.condition(x, y)
    order = rt._greedy_order(3)
    assert order.tolist()[-1] == 1
    first = rt.last_greedy_report["positions"][0]
    assert first["n_obs"][1] == 0 and np.isfinite(first["nll"]).all()


# -- after the fit ----------------------------------------------------------------

#: The fitted model: the dense one on data with missing outputs, normalised,
#: its columns offset so that any column mix-up shows.
OFFSETS = np.array([100.0, -100.0, 3.0])


@pytest.fixture(scope="module")
def fitted():
    kw = dict(DENSE, replace=False, normalise_y=True)
    x, y = _data(missing=True)
    y = y + OFFSETS
    rj = JReg(**kw)
    rj.fit(x, y, greedy=True, iters=ITERS)
    return dict(kw=kw, x=x, y=y, x_test=np.linspace(0.3, 9.7, NT), rj=rj)


def _carried(f, **over):
    """A port estimator at JAX's fitted latents and order."""
    rt = TReg(**dict(f["kw"], **over), device="cpu")
    rt.condition(f["x"], f["y"])
    rt.load_latents(f["rj"].vs.snapshot(), order=f["rj"].order)
    return rt


def test_greedy_fit_matches_jax(fitted):
    f = fitted
    rt = TReg(**f["kw"], device="cpu")
    rt.fit(f["x"], f["y"], greedy=True, iters=ITERS)
    np.testing.assert_array_equal(rt.order, f["rj"].order)
    assert rt.order.tolist() == [2, 0, 1]
    rep, jrep = rt.last_fit_report, f["rj"].last_fit_report
    close(rep["layer_nll"], jrep["layer_nll"], rtol=TOL)
    assert rep["greedy_s"] > 0
    # The conditioned statistics are in layer order, as JAX's.
    close(rt._means, f["rj"]._norm_stats["means"], rtol=1e-15)
    close(rt._stds, f["rj"]._norm_stats["stds"], rtol=1e-15)


def test_predict_in_original_columns_matches_jax(fitted):
    f = fitted
    rt = _carried(f)
    key = jax.random.PRNGKey(5)
    want = f["rj"].predict(f["x_test"], num_samples=S, credible_bounds=True, key=key)
    z1, z2 = jax_chain_normals(key, 3, NT, num_samples=S, noise=True)
    got = rt.predict(f["x_test"], num_samples=S, credible_bounds=True, normals=z1, noise_normals=z2)
    for a, b in zip(got, want):
        assert a.shape == (NT, 3)
        close(a, b, rtol=TOL, atol=1e-10)
    assert np.all(np.abs(np.mean(got[0], axis=0) - OFFSETS) < 5.0)  # each offset in its column


def test_logpdf_in_original_columns_matches_jax(fitted):
    f, rng = fitted, np.random.default_rng(3)
    rt = _carried(f)
    xs = f["x"][::2] + 0.05
    ys = f["y"][::2] + 0.1 * rng.standard_normal((N // 2, 3))
    ws = rng.uniform(0.5, 2.0, (N // 2, 3))
    for post in (False, True):
        close(rt.logpdf(xs, ys, posterior=post), f["rj"].logpdf(xs, ys, posterior=post), rtol=TOL)
        close(rt.logpdf(xs, ys, ws, posterior=post), f["rj"].logpdf(xs, ys, ws, posterior=post),
              rtol=TOL)


def test_sample_in_original_columns_matches_jax(fitted):
    f = fitted
    rt, rj = _carried(f), f["rj"]
    key = jax.random.PRNGKey(8)
    want = rj.sample(f["x_test"], posterior=True, num_samples=S, key=key)
    got = rt.sample(f["x_test"], posterior=True, num_samples=S,
                    normals=jax_chain_normals(key, 3, NT, num_samples=S))
    close(np.stack(got), np.stack(want), rtol=TOL, atol=1e-10)
    # Priors, unnormalised (the statistics have the fitted width): of the
    # fitted width (unpermuted) and of others (layer order).
    rt = _carried(f, normalise_y=False)
    rj = JReg(**dict(f["kw"], normalise_y=False))
    rj.order = f["rj"].order
    rj.condition(f["x"], f["y"])
    rj._ensure_vars(3)
    rj.vs.restore(f["rj"].vs.snapshot())
    for p in (3, 4, 2):
        key = jax.random.PRNGKey(9 + p)
        want = rj.sample(f["x_test"], p=p, num_samples=S, key=key)
        got = rt.sample(f["x_test"], p=p, num_samples=S,
                        normals=jax_chain_normals(key, p, NT, num_samples=S))
        assert got[0].shape == (NT, p)
        close(np.stack(got), np.stack(want), rtol=TOL, atol=1e-10)


@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_order_is_a_relabelling(fitted, model):
    # An estimator under an order equals one conditioned with the identity
    # order on the permuted columns, its results unpermuted: predict,
    # logpdf (prior and posterior, the scan route and the GP core) and
    # sample, bit for bit where the arithmetic is the same.
    f = fitted
    order = f["rj"].order
    over = {} if model == "dense" else dict(x_ind=X_IND)
    rt = _carried(f, **over)
    ref = TReg(**dict(f["kw"], **over), device="cpu")
    ref.condition(f["x"], f["y"][:, order])
    ref.load_latents(f["rj"].vs.snapshot())
    back = np.argsort(order)
    normals = np.random.default_rng(1).standard_normal((3, S, NT))
    for a, b in zip(rt.predict(f["x_test"], num_samples=S, credible_bounds=True, normals=normals,
                               noise_normals=normals),
                    ref.predict(f["x_test"], num_samples=S, credible_bounds=True, normals=normals,
                                noise_normals=normals)):
        np.testing.assert_array_equal(a, b[:, back])
    np.testing.assert_array_equal(
        np.stack(rt.sample(f["x_test"], posterior=True, num_samples=S, normals=normals)),
        np.stack(ref.sample(f["x_test"], posterior=True, num_samples=S, normals=normals))[..., back])
    ys = f["y"][::3]
    for post in (False, True):
        assert rt.logpdf(f["x"][::3], ys, posterior=post) == ref.logpdf(f["x"][::3], ys[:, order],
                                                                         posterior=post)
        # The scan route equals the GP core under the order
        # (``tests/test_greedy.py::test_greedy_logpdf_bucketed_matches_legacy``).
        xn, yn, wn = rt._score_data(f["x"][::3], ys, None, post)
        close(rt._logpdf_scan(xn, yn, wn, post), rt._logpdf_core(xn, yn, wn, post), rtol=1e-9)


def test_carried_order_rebinds_the_conditioned_columns(fitted):
    # load_latents(order=) on an identity-conditioned estimator equals
    # conditioning under the order, and back.
    f = fitted
    rt = _carried(f)
    ref = TReg(**f["kw"], device="cpu")
    ref.order = f["rj"].order
    ref.condition(f["x"], f["y"])
    for a in ("_y_np", "_w_np", "_means", "_stds"):
        np.testing.assert_array_equal(getattr(rt, a), getattr(ref, a))
    rt.load_latents(f["rj"].vs.snapshot())  # the identity order again
    ref.order = None
    ref.condition(f["x"], f["y"])
    assert rt.order is None
    for a in ("_y_np", "_w_np", "_means", "_stds"):
        np.testing.assert_array_equal(getattr(rt, a), getattr(ref, a))
    with pytest.raises(ValueError, match="permutation"):
        rt.load_latents({}, order=[0, 0, 1])


def test_greedy_order_keeps_the_scan_fingerprint(fitted):
    # The graphed step is cached by the plan's fingerprint: a reorder
    # changes only the row arrays, which every fit loads into the buffers.
    f = fitted
    rt = _carried(f)
    ident = TReg(**f["kw"], device="cpu")
    ident.condition(f["x"], f["y"])
    ident._ensure_vars(3)
    pa = rt._scan_fit_plan(rt.vs.select(None))
    pb = ident._scan_fit_plan(ident.vs.select(None))
    assert TF.plan_static_fingerprint(pa) == TF.plan_static_fingerprint(pb)
    assert not np.array_equal(pa.xs["obs_mask"], pb.xs["obs_mask"])
    assert set(TF._ROW_KEYS) == {"route_mask", "obs_mask", "avail", "y_col", "w_col"}


def test_compat_raises_and_mismatched_widths_raise(fitted):
    f = fitted
    x, y = f["x"], f["y"]
    with pytest.raises(NotImplementedError, match="Greedy search is not implemented yet."):
        TReg(noise=0.1, device="cpu").fit(x, y, greedy=True)
    rt = _carried(f)
    for fn in (lambda: rt.logpdf(x, y[:, :1], posterior=True),
               lambda: rt.logpdf(x, y[:, :2]),
               lambda: rt.predict(x, w=np.ones((N, 2)), num_samples=2),
               lambda: rt._unpermute_outputs(np.zeros((2, 4)))):
        with pytest.raises(ValueError, match="greedy output ordering"):
            fn()
    x_before, y_before = rt.x, rt._y_np
    with pytest.raises(ValueError, match="greedy output ordering"):
        rt.condition(x * 2.0, y[:, :1])
    assert rt.x is x_before and rt._y_np is y_before  # left as it was
    for call in (lambda r: r.logpdf(x, y[:, :1], posterior=True), lambda r: r.condition(x, y[:, :1]),
                 lambda r: r._unpermute_outputs(np.zeros((2, 4)))):
        msgs = []
        for r in (f["rj"], rt):
            with pytest.raises(ValueError) as e:
                call(r)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]  # JAX's message, word for word


def test_iters_default_and_second_fit(monkeypatch):
    # Neither package is given iters: the search takes 100 iterations at
    # most and the fit 1000, in both (JAX's search is recorded and handed
    # the port's order, so that its fit runs on the same permutation).  A
    # second greedy fit on the same estimator scores from the same fresh
    # initialisation as a new estimator's.
    x, y, _ = chain_data(n=16, p=2, seed=0)
    kw = dict(DENSE, nonlinear=True, linear_scale=10.0)
    seen = {"jax": [], "port": []}
    t_order, t_fit = TReg._greedy_order, TReg._fit_scan
    monkeypatch.setattr(TReg, "_greedy_order", lambda self, it, *a: (
        seen["port"].append(it), t_order(self, it, *a))[1])
    monkeypatch.setattr(TReg, "_fit_scan", lambda self, it, *a, **k: (
        seen["port"].append(it), t_fit(self, it, *a, **k))[1])
    rt = TReg(**kw, device="cpu")
    rt.fit(x, y, greedy=True)
    monkeypatch.setattr(JReg, "_greedy_order", lambda self, **k: (
        seen["jax"].append(k["iters"]), rt.order)[1])
    rj = JReg(**kw)
    rj.fit(x, y, greedy=True)
    assert seen == {"jax": [100], "port": [100, 1000]}
    assert sorted(rt.order.tolist()) == [0, 1]
    assert max(rt.last_fit_report["layer_iters"]) > 10  # the fit's own default
    close(rt.last_fit_report["layer_nll"], rj.last_fit_report["layer_nll"], rtol=TOL)
    rt.fit(x, y, greedy=True, iters=4)
    fresh = TReg(**kw, device="cpu")
    fresh.fit(x, y, greedy=True, iters=4)
    assert rt.last_greedy_report["order"] == fresh.last_greedy_report["order"]
    for a, b in zip(rt.last_greedy_report["positions"], fresh.last_greedy_report["positions"]):
        assert a["nll"] == b["nll"]
