"""The unrolled oracle of gpar_torch against the JAX package's: the
unrolled fit ``fit(fused="unroll")`` and the unrolled serving routes under
``config.scan_predict = False``, float64 on the CPU (p = 2, n = 30, 6
inducing points, 5 L-BFGS iterations).

- ``fit(fused="unroll")`` against JAX's ``fit(fused="unroll")`` from the
  same initial latents, sparse and dense, ``fix`` True and False, and
  ``restarts=2`` with JAX's perturbations passed as ``restart_normals``
  (the dense ``fix=True`` case through ``fit_predict``, whose unrolled
  chain is JAX's too): ``layer_nll``, ``layer_nll0``, ``layer_iters`` and
  the latents to rtol 1e-6.
- The port's unrolled fit against its scan-fused fit, at the bar of JAX's
  own oracle test (``tests/test_fused_scan.py:71-98``).
- Under ``config.scan_predict = False``: posterior ``sample`` (``replace``
  True on the sparse model, False on the dense one), ``predict``, prior
  ``sample`` and ``logpdf`` (the GP core) against JAX's unrolled routes fed
  the same standard normals (``jax_chain_normals``), rtol 1e-6; draws and
  scores against the port's own scan routes; ``precompute()`` is False and
  no factor slot is filled.
"""

from contextlib import contextmanager

import numpy as np
import pytest

from .test_torch_common import (
    bench_kwargs,
    chain_data,
    close,
    jax,
    jax_chain_normals,
    jax_restart_normals,
    torch,  # noqa: F401
)

from gpar_tpu.config import config as jconfig  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.config import config as tconfig  # noqa: E402

P, N, NT, S, ITERS = 2, 30, 10, 6, 5

# (model, fix, restarts); the dense fix=True case runs through fit_predict.
FIT_CASES = [("sparse", True, 1), ("sparse", False, 1), ("dense", True, 2), ("dense", False, 1)]


def _data():
    x, y, x_test = chain_data(n=N, p=P, seed=0, n_test=NT)
    y[[3, 7, 11], 1] = np.nan
    return x, y, x_test


def _kw(model):
    kw = bench_kwargs(n_ind=6)
    if model == "dense":
        kw.update(x_ind=None, replace=False)
    return kw


@contextmanager
def unrolled():
    """Both packages' serving routes unrolled (``scan_predict`` off)."""
    prev = jconfig.scan_predict, tconfig.scan_predict
    jconfig.scan_predict = tconfig.scan_predict = False
    try:
        yield
    finally:
        jconfig.scan_predict, tconfig.scan_predict = prev


def _widths(reg, fix):
    """The optimised latents' count at each position."""
    reg._ensure_vars(reg.p)
    pats = [[f"{pi}/*"] if fix else [f"{i}/*" for i in range(pi + 1)] for pi in range(reg.p)]
    return [reg.vs.latent_vector(reg.vs.select(p)).shape[0] for p in pats]


@pytest.fixture(scope="module", params=FIT_CASES, ids=lambda c: f"{c[0]}-fix{c[1]}-r{c[2]}")
def unroll_fits(request):
    model, fix, restarts = request.param
    x, y, x_test = _data()
    kw = _kw(model)
    key = jax.random.PRNGKey(7)
    rj, rt = JReg(**kw), TReg(**kw, device="cpu")
    out = dict(model=model, fix=fix, rj=rj, rt=rt)
    if model == "dense" and fix:
        fit_key, sample_key = jax.random.split(key)
        rt.condition(x, y)
        starts = jax_restart_normals(fit_key, "unroll", P, restarts, _widths(rt, fix))
        common = dict(iters=ITERS, fused="unroll", restarts=restarts, num_samples=S,
                      credible_bounds=True)
        with unrolled():
            out["pred_j"] = rj.fit_predict(x, y, x_test, key=key, **common)
            out["pred_t"] = rt.fit_predict(
                x, y, x_test, restart_normals=starts,
                normals=jax_chain_normals(sample_key, P, NT, num_samples=S), **common)
        return out
    starts = None
    if restarts > 1:
        rt.condition(x, y)
        starts = jax_restart_normals(key, "unroll", P, restarts, _widths(rt, fix))
    rj.fit(x, y, iters=ITERS, fused="unroll", fix=fix, restarts=restarts, key=key)
    rt.fit(x, y, iters=ITERS, fused="unroll", fix=fix, restarts=restarts, restart_normals=starts)
    return out


def test_unroll_fit_matches_jax(unroll_fits):
    rj, rt = unroll_fits["rj"], unroll_fits["rt"]
    got, want = rt.last_fit_report, rj.last_fit_report
    assert got["fused"] == "unroll" and got["graph_replays"] == 0
    for k in ("layer_nll", "layer_nll0"):
        close(got[k], want[k], rtol=1e-6)
    np.testing.assert_array_equal(got["layer_iters"], want["layer_iters"])
    assert np.all(got["layer_nll"] < got["layer_nll0"])
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    assert list(sj) == list(st)
    for k in sj:
        close(st[k], sj[k], rtol=1e-6, atol=1e-8)
    if "pred_j" in unroll_fits:
        for a, b in zip(unroll_fits["pred_t"], unroll_fits["pred_j"]):
            close(a, b, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("fix", [True, False])
@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_unroll_fit_matches_scan(model, fix):
    # JAX's own bar (tests/test_fused_scan.py:71-98): at iters=0 the layer
    # NLLs agree to 1e-8; after the optimiser, NLLs to 1e-4 and latents to
    # 2e-3 (line-search decisions may drift at rounding level).
    x, y, _ = _data()
    for iters, tol in ((0, dict(rtol=0, atol=1e-8)), (ITERS, dict(rtol=1e-4, atol=1e-4))):
        runs = []
        for fused in (True, "unroll"):
            r = TReg(**_kw(model), device="cpu")
            r.fit(x, y, iters=iters, fix=fix, fused=fused)
            runs.append(r)
        scan, unroll = runs
        close(scan.last_fit_report["layer_nll"], unroll.last_fit_report["layer_nll"], **tol)
    su, ss = unroll.vs.snapshot(), scan.vs.snapshot()
    for k in su:
        close(ss[k], su[k], rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def served():
    """Both packages' estimators of each model conditioned on the same data
    at the same perturbed latents (no fit)."""
    x, y, x_test = _data()
    out = {}
    for model in ("sparse", "dense"):
        rj, rt = JReg(**_kw(model)), TReg(**_kw(model), device="cpu")
        rj.condition(x, y)
        rt.condition(x, y)
        rj._ensure_vars(P)
        r = np.random.default_rng(3)
        latents = {k: v + 0.2 * r.standard_normal(np.shape(v)) for k, v in rj.vs.snapshot().items()}
        rj.vs.restore(latents)
        rt.load_latents(latents)
        out[model] = (rj, rt)
    return dict(out, x=x, y=y, x_test=x_test)


def test_unrolled_posterior_sample_and_predict_match_jax(served):
    # replace=True here; the dense replace=False chain is JAX's through
    # fit_predict in test_unroll_fit_matches_jax.
    rj, rt = served["sparse"]
    xt = served["x_test"]
    key = jax.random.PRNGKey(11)
    normals = jax_chain_normals(key, P, NT, num_samples=S)
    with unrolled():
        want = np.stack(rj.sample(xt, posterior=True, num_samples=S, key=key))
        got = np.stack(rt.sample(xt, posterior=True, num_samples=S, normals=normals))
        mean, lo, hi = rt.predict(xt, num_samples=S, credible_bounds=True, normals=normals)
    assert want.shape == (S, NT, P)
    close(got, want, rtol=1e-6, atol=1e-10)
    close(mean, want.mean(axis=0), rtol=1e-6, atol=1e-10)
    close(lo, np.percentile(want, 2.5, axis=0), rtol=1e-6, atol=1e-10)
    close(hi, np.percentile(want, 97.5, axis=0), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("latent", [False, True])
@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_unrolled_serving_matches_scan(served, model, latent):
    # From the same normals the unrolled chain draws the scan tails' samples
    # (sparse replace=True, dense replace=False), and it never reads or
    # fills the posterior-factor slot.
    rt = served[model][1]
    xt = served["x_test"]
    normals, noise = np.random.default_rng(5).standard_normal((2, P, S, NT))
    kw = dict(posterior=True, num_samples=S, latent=latent, normals=normals, noise_normals=noise)
    rt._factor_cache = None
    with unrolled():
        got = np.stack(rt.sample(xt, **kw))
        mean = rt.predict(xt, num_samples=S, latent=latent, normals=normals, noise_normals=noise)
        assert rt.precompute() is False
    assert rt._factor_cache is None
    want = np.stack(rt.sample(xt, **kw))
    if latent:
        # A latent covariance is near-singular: its factor is fixed only up
        # to rounding, so the draws are held through their mean and spread.
        close(got.mean(axis=0), want.mean(axis=0), rtol=1e-6, atol=1e-8)
        close(got.std(axis=0), want.std(axis=0), rtol=1e-6, atol=1e-8)
    else:
        close(got, want, rtol=1e-8, atol=1e-10)
    close(rt.predict(xt, num_samples=S, latent=latent, normals=normals, noise_normals=noise), mean,
          rtol=1e-6, atol=1e-8)


def test_unrolled_prior_sample_matches_jax(served):
    rj, rt = served["sparse"]
    xt = served["x_test"]
    key = jax.random.PRNGKey(13)
    normals = jax_chain_normals(key, P, NT, num_samples=S)
    with unrolled():
        want = np.stack(rj.sample(xt, p=P, num_samples=S, key=key))
        got = np.stack(rt.sample(xt, p=P, num_samples=S, normals=normals))
    close(got, want, rtol=1e-6, atol=1e-10)
    scan = np.stack(rt.sample(xt, p=P, num_samples=S, normals=normals))
    close(scan, got, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("model,posterior", [("sparse", True), ("dense", False)])
def test_unrolled_logpdf_matches_jax(served, model, posterior):
    rj, rt = served[model]
    x2, y2, _ = chain_data(n=20, p=P, seed=4)
    y2[[2, 5], 1] = np.nan
    with unrolled():
        want = rj.logpdf(x2, y2, posterior=posterior)
        got = rt.logpdf(x2, y2, posterior=posterior)
    close(got, want, rtol=1e-6)
    close(rt.logpdf(x2, y2, posterior=posterior), got, rtol=1e-9)  # the scan route
