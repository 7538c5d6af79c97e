"""The serving layer of gpar_torch's estimator against gpar_tpu's, float64,
on the CPU: the posterior-factor cache (``precompute``, the cached
``replace=True`` tail, the cached stack fed to the per-sample tail and to
the posterior score) and when the cache engages.

The benchmark's configuration scaled down (p=3, n=40, 8 inducing points or
none, NaNs in the later outputs), both ``replace`` modes, at the latents
of a short fit of the port carried into JAX's store.  Tolerances:

- cached against uncached (``config.posterior_cache = False``) draws,
  means and scores: 1e-12; they are the same operations, so the same bits
  are expected;
- the port's cached path against JAX's cached path, the draws from JAX's
  key stream (``jax_chain_normals``): 1e-8.

A spy on ``fused.make_scan_posterior_factors`` counts the factor
computations: what drops the slot, what hits it.
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jax_chain_normals, torch

import gpar_tpu  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.config import bucket_rows  # noqa: E402
from gpar_torch.config import config as tconfig  # noqa: E402

P, N, NT, S, ITERS = 3, 40, 12, 6, 2
TOL = 1e-8
SPARSE = bench_kwargs(n_ind=8)
DENSE = dict(SPARSE, x_ind=None)
MODELS = {"sparse": SPARSE, "dense": DENSE}
SERVE = [(m, r) for m in MODELS for r in (True, False)]
IDS = [f"{m}-replace={r}" for m, r in SERVE]


def _data(n=N, seed=0):
    x, y, x_test = chain_data(n=n, p=P, seed=seed, n_test=NT)
    r = np.random.default_rng(4 + seed)
    y[:, 1:][r.uniform(size=(n, P - 1)) < 0.12] = np.nan
    return x, y, x_test


@pytest.fixture(scope="module")
def latents():
    """A short fit of each model in the port: the tests' hyperparameters."""
    x, y, _ = _data()
    out = {}
    for name, kw in MODELS.items():
        rt = TReg(**kw, device="cpu")
        rt.fit(x, y, iters=ITERS)
        out[name] = rt.vs.snapshot()
    return out


def _port(latents, model, replace):
    x, y, _ = _data()
    rt = TReg(**dict(MODELS[model], replace=replace), device="cpu")
    rt.condition(x, y)
    rt.load_latents(latents[model])
    return rt


def _jax(latents, model, replace):
    x, y, _ = _data()
    rj = JReg(**dict(MODELS[model], replace=replace))
    rj.condition(x, y)
    rj._ensure_vars(P)
    rj.vs.restore(latents[model])
    return rj


@pytest.fixture
def spy(monkeypatch):
    """Counts the stacked factor computations of the port."""
    calls = []
    real = TF.make_scan_posterior_factors

    def counted(*a, **k):
        inner = real(*a, **k)

        def factors(*b, **kk):
            calls.append(1)
            return inner(*b, **kk)

        return factors

    monkeypatch.setattr(TF, "make_scan_posterior_factors", counted)
    return calls


def _serve(rt, key):
    """Predict with bounds, posterior samples and the posterior score of
    other data, all from JAX's key stream."""
    x_test = _data()[2]
    xs, ys, _ = _data(n=20, seed=3)
    z = jax_chain_normals(key, P, NT, num_samples=S)
    pred = rt.predict(x_test, num_samples=S, credible_bounds=True, normals=z)
    samples = np.stack(rt.sample(x_test, posterior=True, num_samples=S, normals=z))
    return (*pred, samples, np.asarray(rt.logpdf(xs, ys, posterior=True)))


@pytest.mark.parametrize("model,replace", SERVE, ids=IDS)
def test_cached_serving_equals_uncached(latents, spy, model, replace):
    rt = _port(latents, model, replace)
    key = jax.random.PRNGKey(5)
    assert rt.precompute() is True and len(spy) == 1
    cached = _serve(rt, key)
    assert len(spy) == 1  # every call hit the precomputed slot
    try:
        tconfig.posterior_cache = False
        assert rt.precompute() is False
        plain = _serve(rt, key)
    finally:
        tconfig.posterior_cache = True
    assert len(spy) == 1  # the uncached calls condition inside their tails
    for a, b in zip(cached, plain):
        close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("model,replace", SERVE, ids=IDS)
def test_cached_serving_matches_jax(latents, model, replace):
    rt, rj = _port(latents, model, replace), _jax(latents, model, replace)
    assert rj.precompute() is True and rt.precompute() is True
    x_test = _data()[2]
    xs, ys, _ = _data(n=20, seed=3)
    key = jax.random.PRNGKey(6)
    want = np.stack(rj.sample(x_test, posterior=True, num_samples=S, key=key))
    got = np.stack(rt.sample(x_test, posterior=True, num_samples=S,
                             normals=jax_chain_normals(key, P, NT, num_samples=S)))
    close(got, want, rtol=TOL, atol=1e-10)
    close(rt.logpdf(xs, ys, posterior=True), rj.logpdf(xs, ys, posterior=True), rtol=TOL)


def test_fit_condition_load_latents_and_reorder_drop_the_slot(latents, spy):
    x, y, x_test = _data()
    rt = _port(latents, "sparse", True)

    def hits(n_new):
        before = len(spy)
        rt.predict(x_test, num_samples=2, normals=np.zeros((P, 2, NT)))
        assert len(spy) - before == n_new

    assert rt.precompute() and len(spy) == 1
    hits(0)
    rt.fit(x, y, iters=1)
    assert rt._factor_cache is None
    hits(1)
    rt.condition(x, y)
    assert rt._factor_cache is None
    hits(1)
    rt.load_latents(latents["sparse"])
    assert rt._factor_cache is None
    hits(1)
    rt._reorder([1, 0, 2])  # what a greedy order or a checkpoint's order does
    assert rt._factor_cache is None
    hits(1)
    hits(0)


def test_slot_of_another_row_bucket_misses(latents, spy):
    # The key holds the row bucket (the JAX key does not): a slot left from
    # data in another bucket, at the same latents, is not served.
    rt = _port(latents, "dense", True)
    assert rt.precompute() and len(spy) == 1
    stale = rt._factor_cache
    x2, y2, _ = _data(n=90, seed=1)
    assert bucket_rows(90) != bucket_rows(N)
    rt.condition(x2, y2)
    rt._factor_cache = stale
    assert rt.precompute() and len(spy) == 2
    assert rt._factor_cache[0][0] == bucket_rows(90) != stale[0][0]
    assert rt._factor_cache[1]["L"].shape[-1] == bucket_rows(90)


def test_jitter_settings_are_part_of_the_key(latents, spy, monkeypatch):
    # The factorisations bake the jitter in, as the graph cache's steps do.
    rt = _port(latents, "sparse", True)
    assert rt.precompute() and rt.precompute() and len(spy) == 1
    monkeypatch.setattr(tconfig, "epsilon", 1e-9)
    assert rt.precompute() and len(spy) == 2


def test_fit_predict_fills_the_slot(latents, spy):
    x, y, x_test = _data()
    rt = TReg(**SPARSE, device="cpu")
    z = np.random.default_rng(1).standard_normal((P, S, NT))
    first = rt.fit_predict(x, y, x_test, num_samples=S, normals=z, iters=ITERS)
    assert len(spy) == 1 and rt._factor_cache is not None
    again = rt.predict(x_test, num_samples=S, normals=z)
    assert len(spy) == 1  # the next predict hits
    close(again, first, rtol=0)


def test_precompute_where_jax_does(latents, monkeypatch):
    cases = {}
    for model, replace in SERVE:
        cases[model, replace] = (_port(latents, model, replace), _jax(latents, model, replace))
    for (model, replace), (rt, rj) in cases.items():
        assert rt.precompute() is rj.precompute() is True, (model, replace)
    # A dense stack over the byte limit is refused; a sparse one never is.
    monkeypatch.setattr(gpar_tpu.config, "posterior_cache_max_bytes", 8)
    monkeypatch.setattr(tconfig, "posterior_cache_max_bytes", 8)
    for (model, replace), (rt, rj) in cases.items():
        rt._factor_cache = rj._factor_cache = None
        want = rj.precompute()
        assert want is (model == "sparse")
        assert rt.precompute() is want and (rt._factor_cache is None) == (not want)
    monkeypatch.undo()
    # The cache switched off: nothing is cached.
    monkeypatch.setattr(gpar_tpu.config, "posterior_cache", False)
    monkeypatch.setattr(tconfig, "posterior_cache", False)
    for (model, replace), (rt, rj) in cases.items():
        rt._factor_cache = rj._factor_cache = None
        assert rt.precompute() is rj.precompute() is False
        assert rt._factor_cache is None
    for cls, kw in ((TReg, dict(device="cpu")), (JReg, {})):
        with pytest.raises(RuntimeError, match="condition"):
            cls(noise=0.1, **kw).precompute()


def test_byte_limit_is_reckoned_at_the_row_bucket(latents, monkeypatch):
    # p * rows * (rows + W + 1) elements at the bucket (64 rows for n=40).
    rt = _port(latents, "dense", True)
    plan = rt._scan_fit_plan(rt.vs.select(None))
    n_b = bucket_rows(N)
    need = P * n_b * (n_b + plan.W + 1) * 8
    monkeypatch.setattr(tconfig, "posterior_cache_max_bytes", need)
    assert rt._factor_stack_fits(plan)
    monkeypatch.setattr(tconfig, "posterior_cache_max_bytes", need - 1)
    assert not rt._factor_stack_fits(plan)
    factors = TF.make_scan_posterior_factors(plan, None, rows_traced=True)(
        rt.vs.latent_vector(rt.vs.select(None)), *rt._bucket_fit_inputs(plan))
    assert sum(v.numel() for v in factors.values()) * 8 == need


def test_cached_tail_requires_replace(latents):
    rt = _port(latents, "sparse", False)
    plan = rt._scan_fit_plan(rt.vs.select(None))
    with pytest.raises(ValueError, match="replace=True"):
        TF.make_scan_cached_tail(plan, latent=False)


def test_cached_tail_equals_the_conditioning_tail(latents):
    # The two replace=True tails, called directly at the bucket, both
    # latent modes: the same bits.
    rt = _port(latents, "sparse", True)
    names = rt.vs.select(None)
    plan = rt._scan_fit_plan(names)
    x_pad, rows = rt._bucket_fit_inputs(plan)
    z = rt.vs.latent_vector(names)
    xt = torch.as_tensor(_data()[2][:, None])
    w = torch.ones(P, NT, dtype=torch.float64)
    normals = torch.as_tensor(np.random.default_rng(2).standard_normal((P, S, NT)))
    stack = TF.make_scan_posterior_factors(plan, rt.x_ind, rows_traced=True)(z, x_pad, rows)
    for latent in (False, True):
        want = TF.make_scan_predict_tail(plan, rt.x_ind, latent, rows_traced=True)(
            z, x_pad, xt, w, normals, rows)
        got = TF.make_scan_cached_tail(plan, latent, rows_traced=True)(z, stack, xt, w, normals, rows)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
