"""The log-density of gpar_torch (``GPARRegressor.logpdf``, the scan-fused
prior body and posterior tail of ``models/fused.py``, and
``GPAR.logpdf(sample_missing=True)``) against gpar_tpu's, float64, on the
CPU.

The benchmark's configuration scaled down (p=3, 40 training rows, 25 scored
rows with NaNs in every output and non-unit weights; sparse with 8
inducing points and dense).  Both packages hold the same perturbed latents
(``load_latents``).  Tolerance 1e-9 relative throughout, and:

- the scan route against the port's own GP-core route: 1e-9;
- the bucketed scan bodies against the exact-shape ones: 1e-12;
- no data: the score is 0 to 1e-10 (the jittered factors of empty
  observations add about 1e-11), as JAX's.
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jax_missing_normals, torch

import gpar_tpu.models.fused as JF  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402

P, RTOL = 3, 1e-9


def _train():
    x, y, _ = chain_data(n=40, p=P, seed=0)
    y[[4, 17, 30], 1] = np.nan
    y[[9, 22], 2] = np.nan
    return x, y


def _scored():
    """Scored data: NaNs in every output and non-unit weights."""
    x, y, _ = chain_data(n=25, p=P, seed=7)
    r = np.random.default_rng(11)
    y[r.uniform(size=y.shape) < 0.15] = np.nan
    return x, y, r.uniform(0.5, 2.0, y.shape)


def _kw(sparse, **kw):
    out = dict(bench_kwargs(n_ind=8), **kw)
    if not sparse:
        out["x_ind"] = None
    return out


def _pair(sparse, **kw):
    """JAX's and the port's estimators conditioned on the same data, with
    the same perturbed latents."""
    x, y = _train()
    rj, rt = JReg(**_kw(sparse, **kw)), TReg(**_kw(sparse, **kw), device="cpu")
    for reg in (rj, rt):
        reg.condition(x, y)
        reg._ensure_vars(P)
    r = np.random.default_rng(8)
    latents = {k: v + 0.2 * r.standard_normal(np.shape(v)) for k, v in rj.vs.snapshot().items()}
    rj.vs.restore(latents)
    rt.load_latents(latents)
    return rj, rt


@pytest.fixture(scope="module")
def pairs():
    return {sparse: _pair(sparse) for sparse in (True, False)}


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("impute,replace", [(True, True), (True, False), (False, True), (False, False)])
def test_prior_score_matches_jax(sparse, impute, replace):
    rj, rt = _pair(sparse, impute=impute, replace=replace)
    xs, ys, ws = _scored()
    got = rt.logpdf(xs, ys, ws)
    assert isinstance(got, float)
    close(got, rj.logpdf(xs, ys, ws), rtol=RTOL)


@pytest.mark.parametrize("compat", [True, False])
def test_compat_modes_match_jax(compat):
    rj, rt = _pair(True, compat=compat)
    assert rt.normalise_y
    xs, ys, _ = _scored()
    for posterior in (False, True):
        close(rt.logpdf(xs, ys, posterior=posterior), rj.logpdf(xs, ys, posterior=posterior), rtol=RTOL)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_never_conditioned_estimator_matches_jax(sparse):
    # The scored (m, p) instantiates the variables at their initial values.
    rj, rt = JReg(**_kw(sparse)), TReg(**_kw(sparse), device="cpu")
    xs, ys, ws = _scored()
    close(rt.logpdf(xs, ys, ws), rj.logpdf(xs, ys, ws), rtol=RTOL)
    assert sorted(rt.vs.names) == sorted(rj.vs.names)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_posterior_score_matches_jax(pairs, sparse):
    rj, rt = pairs[sparse]
    xs, ys, ws = _scored()
    close(rt.logpdf(xs, ys, ws, posterior=True), rj.logpdf(xs, ys, ws, posterior=True), rtol=RTOL)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_posterior_of_another_width_takes_the_gp_core(sparse):
    # Without normalisation: the conditioned statistics have the
    # conditioned width.
    rj, rt = _pair(sparse, normalise_y=False)
    xs, ys, ws = _scored()
    args = rt._score_data(xs, ys[:, :2], ws[:, :2], True)
    assert rt._logpdf_scan(*args, True) is None
    close(rt.logpdf(xs, ys[:, :2], ws[:, :2], posterior=True),
          rj.logpdf(xs, ys[:, :2], ws[:, :2], posterior=True), rtol=RTOL)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_scan_route_matches_gp_core_route(pairs, sparse):
    _, rt = pairs[sparse]
    xs, ys, ws = _scored()
    for posterior in (False, True):
        args = rt._score_data(xs, ys, ws, posterior)
        close(float(rt._logpdf_scan(*args, posterior)), rt._logpdf_core(*args, posterior), rtol=RTOL)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_scan_bodies_match_jax_and_their_bucketed_forms(pairs, sparse):
    """The fused prior body and posterior tail at the plan's exact rows
    against JAX's, and bucketed against exact."""
    rj, rt = pairs[sparse]
    xs, ys, ws = _scored()
    ys = np.asarray(ys)
    names = rt.vs.select(None)
    z = rt.vs.latent_vector(names)
    zj = rj.vs.latent_vector(names)
    pt = TF.build_scan_data_plan(rt, xs[:, None], ys, ws, names)
    pj = JF.build_scan_data_plan(rj, xs[:, None], ys, ws, names)
    x_t = torch.as_tensor(xs[:, None])
    prior = TF.make_scan_logpdf_body(pt, rt.x_ind)(z, x_t)
    close(prior, JF.make_scan_logpdf_body(pj, rj.x_ind)(zj, xs[:, None]), rtol=RTOL)
    x_pad, rows = rt._bucket_score_inputs(pt, xs[:, None], ys, ws)
    close(TF.make_scan_logpdf_body(pt, rt.x_ind, rows_traced=True)(z, x_pad, rows), prior, rtol=1e-12)

    plan_tr = rt._scan_fit_plan(names)
    x_tr, rows_tr = rt._bucket_fit_inputs(plan_tr)
    tr_mask = None if sparse else rows_tr["obs_mask"]

    def factors():
        return TF.posterior_factor_layers(plan_tr, rt.x_ind, rows_traced=True)(z, x_tr, rows_tr)

    tail = TF.make_scan_posterior_logpdf_tail(pt, rt.x_ind)
    exact = tail(z, factors(), x_t, tr_mask=tr_mask)
    bucketed = TF.make_scan_posterior_logpdf_tail(pt, rt.x_ind, rows_traced=True)(
        z, factors(), x_pad, rows, tr_mask)
    close(bucketed, exact, rtol=1e-12)
    # The estimator un-normalises the scored outputs (compat=True), so it is
    # given the normalised ones to score ``ys``.
    close(exact, rj.logpdf(xs, (ys - rt._means) / rt._stds, ws, posterior=True), rtol=RTOL)
    if not sparse:
        with pytest.raises(ValueError, match="tr_mask"):
            tail(z, factors(), x_t)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("posterior", [False, True], ids=["prior", "posterior"])
def test_sample_missing_matches_jax(pairs, sparse, posterior):
    rj, rt = pairs[sparse]
    xs, ys, ws = _scored()
    key = jax.random.PRNGKey(5)
    normals = jax_missing_normals(key, ys)
    assert len(normals) == P - 1
    want = rj.logpdf(xs, ys, ws, posterior=posterior, sample_missing=True, key=key)
    got = rt.logpdf(xs, ys, ws, posterior=posterior, sample_missing=True, normals=normals)
    close(got, want, rtol=RTOL)
    # Normals from a generator: the same seed, the same score.
    again = [rt.logpdf(xs, ys, ws, posterior=posterior, sample_missing=True,
                       generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert again[0] == again[1] and np.isfinite(again[0])
    with pytest.raises(ValueError, match="normals"):
        rt.logpdf(xs, ys, ws, posterior=posterior, sample_missing=True, normals=normals[:1])


def test_posterior_before_fit_raises():
    xs, ys, _ = _scored()
    with pytest.raises(RuntimeError, match="condition"):
        TReg(**_kw(True), device="cpu").logpdf(xs, ys, posterior=True)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_no_data_scores_zero(pairs, sparse):
    rj, rt = pairs[sparse]
    xs, ys, _ = _scored()
    for posterior in (False, True):
        got = rt.logpdf(xs[:0], ys[:0], posterior=posterior)
        close(got, 0.0, rtol=0, atol=1e-10)
        close(got, rj.logpdf(xs[:0], ys[:0], posterior=posterior), rtol=RTOL, atol=1e-15)
