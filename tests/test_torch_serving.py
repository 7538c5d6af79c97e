"""The serving layer of gpar_torch's estimator against gpar_tpu's, float64,
on the CPU: the posterior-factor cache (``precompute``, the cached
``replace=True`` tail, the cached stack fed to the per-sample tail and to
the posterior score) and when the cache engages; the body that the card
replays as the cached tail's CUDA graph (``fused.CachedTailBody``), run
eagerly with its one read and its repair, the body of the uncached
tail's graph (``fused.UncachedTailBody``) likewise, and the routes that
enter the two graphs (``graphs.graphed_tail``, ``graphs.graphed_uncached_tail``,
stubbed here).

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

import contextlib

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jax_chain_normals, torch

import gpar_tpu  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch  # noqa: E402
import gpar_torch.models.fused as TF  # noqa: E402
import gpar_torch.models.graphs as TGr  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.parallel import make_mesh  # noqa: E402
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


def _tail_args(rt, x_test, seed=2, w=None):
    """The cached tail's arguments as the estimator's cached predict makes
    them: the slot's factors, the test inputs padded to their bucket and
    masked, the bucketed training rows, normals from ``seed``."""
    names = rt.vs.select(None)
    plan = rt._scan_fit_plan(names)
    _, rows = rt._bucket_fit_inputs(plan)
    z = rt.vs.latent_vector(names)
    nb = bucket_rows(NT)
    x_t = torch.as_tensor(np.pad(x_test[:, None], ((0, nb - NT), (0, 0))))
    w_t = torch.ones(P, nb, dtype=torch.float64) if w is None else w
    mt = torch.as_tensor((np.arange(nb) < NT).astype(np.float64))
    normals = torch.as_tensor(np.random.default_rng(seed).standard_normal((P, S, nb)))
    return plan, (z, rt._posterior_factors(plan, z), x_t, w_t, normals, rows, mt)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("latent", [False, True], ids=["observed", "latent"])
def test_tail_body_run_eagerly_equals_the_cached_tail(latents, model, latent):
    # The graph's body, its one read and its repair, run eagerly: built
    # from one call's arguments, then loaded with another's.
    rt = _port(latents, model, True)
    plan, first = _tail_args(rt, _data()[2], seed=1)
    body = TF.CachedTailBody(plan, latent, *first)
    for seed in (2, 3):
        _, args = _tail_args(rt, _data()[2], seed=seed)
        body.load(*args)
        got = TF.run_tail(body, TF.Eager(body))
        want = TF.make_scan_cached_tail(plan, latent, rows_traced=True)(*args)
        assert not body.tail()[2].any()  # no first rung failed: nothing repaired
        for a, b in zip(got, want):
            close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_tail_repairs_only_the_layer_whose_first_rung_failed(latents, model, monkeypatch):
    # Duplicate test inputs, layer 1's observation noise weighted down to
    # nothing and the jitter lowered to -1e-4: that layer's covariance is
    # singular, so its first rung factors a matrix with an eigenvalue near
    # -1e-4 and fails; the other layers' noise keeps theirs definite.
    rt = _port(latents, model, True)
    x_test = _data()[2]
    x_test[:4] = x_test[0]
    w = torch.ones(P, bucket_rows(NT), dtype=torch.float64)
    w[1] = 1e30
    plan, args = _tail_args(rt, x_test, w=w)  # the factors at the usual jitter
    monkeypatch.setattr(tconfig, "epsilon", -1e-4)
    repaired = []
    real = TF.CachedTailBody.repair_layer

    def counted(self, pi, *a):
        repaired.append(pi)
        return real(self, pi, *a)

    monkeypatch.setattr(TF.CachedTailBody, "repair_layer", counted)
    body = TF.CachedTailBody(plan, False, *args)
    body.load(*args)
    assert body.tail()[2].nonzero().flatten().tolist() == [1]
    got = TF.run_tail(body, TF.Eager(body))
    want = TF.make_scan_cached_tail(plan, False, rows_traced=True)(*args)
    assert repaired == [1]
    assert torch.isfinite(got[0]).all()
    for a, b in zip(got, want):
        close(a, b, rtol=1e-12, atol=1e-12)


def _uncached_args(rt, x_test, seed=2, w=None):
    """The uncached tail's arguments as the estimator's predict makes them:
    the bucketed training inputs in place of the slot's factors."""
    plan, (z, _, *rest) = _tail_args(rt, x_test, seed, w)
    return plan, (z, rt._bucket_fit_inputs(plan)[0], *rest)


def _with_x_ind(rt, args):
    """The uncached tail's arguments with the inducing inputs after the
    training inputs, as the body takes them."""
    z, x_pad, *rest = args
    return (z, x_pad, rt.x_ind, *rest)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("latent", [False, True], ids=["observed", "latent"])
def test_uncached_tail_body_run_eagerly_equals_the_predict_tail(latents, model, latent):
    # The uncached graph's body (every training factor and sampling factor
    # at its first rung), its one read, run eagerly: built from one call's
    # arguments, then loaded with another's; the eager tail's bits.
    rt = _port(latents, model, True)
    plan, first = _uncached_args(rt, _data()[2], seed=1)
    body = TF.UncachedTailBody(plan, latent, *_with_x_ind(rt, first))
    for seed in (2, 3):
        _, args = _uncached_args(rt, _data()[2], seed=seed)
        body.load(*_with_x_ind(rt, args))
        got = TF.run_tail(body, TF.Eager(body))
        want = TF.make_scan_predict_tail(plan, rt.x_ind, latent, rows_traced=True)(*args)
        assert body.tail()[2].tolist() == [0] * (P + 1)  # nothing failed: nothing run again
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("model", MODELS)
def test_uncached_tail_runs_the_whole_eager_tail_where_a_first_rung_failed(latents, model,
                                                                         monkeypatch):
    # The cached tail's forced failure (layer 1's sampling factor, at the
    # jitter -1e-4): the replay's draws are thrown away and the whole eager
    # tail, every factorisation on the host ladder, gives the answer.
    rt = _port(latents, model, True)
    x_test = _data()[2]
    x_test[:4] = x_test[0]
    w = torch.ones(P, bucket_rows(NT), dtype=torch.float64)
    w[1] = 1e30
    plan, args = _uncached_args(rt, x_test, w=w)
    monkeypatch.setattr(tconfig, "epsilon", -1e-4)
    body = TF.UncachedTailBody(plan, False, *_with_x_ind(rt, args))
    body.load(*_with_x_ind(rt, args))
    assert body.tail()[2][1] != 0
    repairs = []
    monkeypatch.setattr(body, "repair", lambda *a, real=body.repair: repairs.append(1) or real(*a))
    got = TF.run_tail(body, TF.Eager(body))
    want = TF.make_scan_predict_tail(plan, rt.x_ind, False, rows_traced=True)(*args)
    assert repairs == [1] and torch.isfinite(got[0]).all()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("route, cached, uncached", [
    ("cached-sparse", 2, 0), ("cached-dense", 2, 0), ("cpu", 0, 0), ("uncached", 0, 2),
    ("uncached-dense", 0, 2), ("replace=False", 0, 0), ("mesh", 0, 0),
])
def test_tail_graphs_are_entered_on_the_card_replace_true_routes(latents, route, cached,
                                                                 uncached, monkeypatch):
    # Counting stubs on the two graphs' entries, the device test made to say
    # "card" (except on the cpu route): a replace=True predict and posterior
    # sample with no mesh enter the cached tail's graph from cached factors
    # and the uncached tail's graph without them; no other route enters one.
    calls = {"cached": [], "uncached": []}

    def stub(plan, latent, *args):
        calls["cached"].append(latent)
        return TF.make_scan_cached_tail(plan, latent, rows_traced=True)(*args)

    def uncached_stub(plan, x_ind, latent, *args):
        calls["uncached"].append(latent)
        return TF.make_scan_predict_tail(plan, x_ind, latent, rows_traced=True)(*args)

    monkeypatch.setattr(TGr, "graphed_tail", stub)
    monkeypatch.setattr(TGr, "graphed_uncached_tail", uncached_stub)
    if route != "cpu":
        monkeypatch.setattr(TGr, "on_card", lambda device: True)
    if route.startswith("uncached"):
        monkeypatch.setattr(tconfig, "posterior_cache", False)
    rt = _port(latents, "dense" if route.endswith("dense") else "sparse", route != "replace=False")
    x_test = _data()[2]
    z = np.random.default_rng(1).standard_normal((P, S, NT))
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2) if route == "mesh" else None
    with gpar_torch.use_mesh(mesh, min_rows=8) if mesh else contextlib.nullcontext():
        pred = rt.predict(x_test, num_samples=S, normals=z)
        rt.sample(x_test, posterior=True, num_samples=S, latent=True, normals=z)
    assert calls == {"cached": [False, True][:cached], "uncached": [False, True][:uncached]}
    if cached or uncached:
        monkeypatch.undo()
        close(rt.predict(x_test, num_samples=S, normals=z), pred, rtol=0)
