"""The estimator of gpar_torch under a device mesh (``use_mesh`` and
``mesh=``), float64 on the CPU, on a virtual mesh of 3 CPU shards: 3
leaves padding rows to whole shards on both the
sparse and the dense scan routes (the 64-row bucket of 42 rows becomes 66
and 96 rows), and padding samples and candidates to a mesh multiple.

Each case is held against the port's own one-device route from the same
latents and normals at 1e-7 (``iters=0`` for the fits), then against the
JAX package's one-device estimator at JAX's own bars for its mesh routes
(``tests/test_fused_scan.py:560-610``, ``tests/test_parallel.py:141-250``):
after L-BFGS iterations layer NLLs to 1e-4 and latents to 2e-3, a
``fit_predict`` to 1e-2; serving from the same latents to 1e-6.  JAX's
fits are made once per model and ``fix`` and shared.

- ``fit`` sparse and dense, ``fix`` True and False (p = 2, n = 42, rows
  missing in the second output);
- ``fit_predict`` with missing outputs (``impute``, ``replace``);
- ``predict`` with ``num_samples = 5`` (not a multiple of 3), posterior and
  prior ``sample``, ``logpdf`` prior and posterior (the dense posterior
  through the GP core's sharded ``Obs``), and ``precompute`` under a mesh;
- ``restarts=2`` in float64 under a mesh (JAX's TPU-only guard is not
  ported);
- greedy order and scores under a mesh (the candidate axis padded);
- ``fused="batched"`` raising JAX's ``ValueError``; the small-n fallback to
  the unrolled route; a mesh step never replaying a one-device graph.
"""

import contextlib

import numpy as np
import pytest

from .test_torch_common import (
    bench_kwargs,
    chain_data,
    close,
    jax,
    jax_chain_normals,
    jax_restart_normals,
    torch,
)

import gpar_tpu  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402
from gpar_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402

import gpar_torch  # noqa: E402
import gpar_torch.models.fused as TF  # noqa: E402
import gpar_torch.models.graphs as TGr  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.config import config as tconfig  # noqa: E402
from gpar_torch.parallel import make_mesh  # noqa: E402

P, N, NT, S, ITERS = 2, 42, 10, 5, 6
CPU = torch.device("cpu")
FIT_BAR = dict(rtol=1e-4, atol=1e-4)  # JAX's mesh-against-one-device bar after iterations


def cpu_mesh(n=3):
    return make_mesh(n, devices=[CPU] * n)


def on_mesh(n=3):
    """A virtual CPU mesh that shards these small datasets."""
    return gpar_torch.use_mesh(cpu_mesh(n), min_rows=8)


def _data():
    x, y, x_test = chain_data(n=N, p=P, seed=0, n_test=NT)
    y[[3, 7, 11], 1] = np.nan
    return x, y, x_test


def _kw(model):
    kw = bench_kwargs(n_ind=6)
    if model == "dense":
        kw.update(x_ind=None, replace=False)
    return kw


_JAX_FITS = {}


def _jax_fit(model, fix):
    """JAX's one-device fit of the data, ``iters=ITERS``, made once."""
    if (model, fix) not in _JAX_FITS:
        x, y, _ = _data()
        rj = JReg(**_kw(model))
        rj.fit(x, y, iters=ITERS, fix=fix)
        _JAX_FITS[model, fix] = rj
    return _JAX_FITS[model, fix]


def _latents_close(a, b, **tol):
    sa, sb = a.vs.snapshot(), b.vs.snapshot()
    assert list(sa) == list(sb)
    for k in sa:
        close(sa[k], sb[k], **tol)


# -- the fits ------------------------------------------------------------------


@pytest.mark.parametrize("fix", [True, False])
@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_fit_under_mesh(model, fix):
    x, y, _ = _data()
    runs = {}
    for name, ctx in (("single", contextlib.nullcontext), ("mesh", on_mesh)):
        for iters in (0, ITERS):
            r = TReg(**_kw(model), device="cpu")
            with ctx():
                r.fit(x, y, iters=iters, fix=fix)
            runs[name, iters] = r
    for iters in (0, ITERS):
        got, want = runs["mesh", iters].last_fit_report, runs["single", iters].last_fit_report
        assert got["fused"] is True and got["graph_replays"] == 0
        close(got["layer_nll"], want["layer_nll"], rtol=0, atol=1e-7)
    close(runs["mesh", 0].last_fit_report["layer_nll0"], runs["single", 0].last_fit_report["layer_nll0"],
          rtol=0, atol=1e-7)
    rj = _jax_fit(model, fix)
    close(runs["mesh", ITERS].last_fit_report["layer_nll"], rj.last_fit_report["layer_nll"], **FIT_BAR)
    _latents_close(runs["mesh", ITERS], rj, rtol=2e-3, atol=2e-3)


def test_fit_predict_with_missing_outputs_under_mesh():
    # impute=True, replace=True (the bench's model): the fit imputes the
    # missing rows of output 1 from the sharded estimates.
    x, y, x_test = _data()
    key = jax.random.PRNGKey(6)
    normals = jax_chain_normals(jax.random.split(key)[1], P, NT, num_samples=S)
    kw = dict(num_samples=S, credible_bounds=True, normals=normals)
    mesh = dict(mesh=cpu_mesh())
    with on_mesh():  # for its min_rows; mesh= names the mesh too
        got0 = TReg(**_kw("sparse"), device="cpu").fit_predict(x, y, x_test, iters=0, **mesh, **kw)
        got = TReg(**_kw("sparse"), device="cpu").fit_predict(x, y, x_test, iters=ITERS, **kw)
    want0 = TReg(**_kw("sparse"), device="cpu").fit_predict(x, y, x_test, iters=0, **kw)
    for a, b in zip(got0, want0):
        close(a, b, rtol=0, atol=1e-7)
    # JAX's fit_predict is its fit, then its predict with the second half
    # of the key.
    want = _jax_fit("sparse", True).predict(x_test, num_samples=S, credible_bounds=True,
                                            key=jax.random.split(key)[1])
    for a, b in zip(got, want):
        close(a, b, rtol=0, atol=1e-2)


def test_restarts_in_float64_under_mesh():
    # JAX raises for this fit under a TPU mesh (a crash of its runtime); the
    # port runs it.  Dense: each start factors through the distributed
    # Cholesky.
    x, y, _ = _data()
    rt = TReg(**_kw("dense"), device="cpu")
    rt.condition(x, y)
    rt._ensure_vars(P)
    s_max = rt._scan_fit_plan(rt.vs.select(None)).s_max
    key = jax.random.PRNGKey(3)
    starts = jax_restart_normals(key, "scan", P, 2, s_max)
    single = TReg(**_kw("dense"), device="cpu")
    single.fit(x, y, iters=ITERS, restarts=2, restart_normals=starts)
    with on_mesh():
        rt.fit(x, y, iters=ITERS, restarts=2, restart_normals=starts)
    rep = rt.last_fit_report
    assert rep["restarts"] == 2 and rt.dtype == torch.float64
    close(rep["layer_nll"], single.last_fit_report["layer_nll"], rtol=1e-7)
    rj = JReg(**_kw("dense"))
    rj.fit(x, y, iters=ITERS, restarts=2, key=key)
    close(rep["layer_nll"], rj.last_fit_report["layer_nll"], **FIT_BAR)


def test_batched_fit_under_mesh_raises_jax_error():
    x, y, _ = _data()
    with gpar_tpu.use_mesh(j_make_mesh(2, devices=jax.devices("cpu"))):
        with pytest.raises(ValueError) as want:
            JReg(**_kw("dense"))._use_scan_body("batched")
    with pytest.raises(ValueError) as got:
        TReg(**_kw("dense"), device="cpu").fit(x, y, iters=1, fused="batched", mesh=cpu_mesh())
    assert str(got.value) == str(want.value)


def test_small_fit_under_mesh_takes_the_unrolled_route():
    # Fewer rows than shard_min_rows (1024): the unrolled route, as JAX's
    # _use_scan_body decides.
    x, y, _ = _data()
    r = TReg(**_kw("sparse"), device="cpu")
    r.fit(x, y, iters=2, mesh=cpu_mesh())
    ref = TReg(**_kw("sparse"), device="cpu")
    ref.fit(x, y, iters=2, fused="unroll")
    assert r.last_fit_report["fused"] == "unroll"
    close(r.last_fit_report["layer_nll"], ref.last_fit_report["layer_nll"], rtol=1e-10)


# -- serving ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """Per model a JAX estimator and two port estimators (one used under a
    mesh) conditioned on the same data at the same perturbed latents."""
    x, y, x_test = _data()
    out = dict(x=x, y=y, x_test=x_test)
    for model in ("sparse", "dense"):
        rj = JReg(**_kw(model))
        rj.condition(x, y)
        rj._ensure_vars(P)
        r = np.random.default_rng(3)
        latents = {k: v + 0.2 * r.standard_normal(np.shape(v)) for k, v in rj.vs.snapshot().items()}
        rj.vs.restore(latents)
        ports = []
        for _ in range(2):
            rt = TReg(**_kw(model), device="cpu")
            rt.condition(x, y)
            rt.load_latents(latents)
            ports.append(rt)
        out[model] = (rj, *ports)
    return out


@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_predict_under_mesh(served, model):
    rj, single, rt = served[model]
    xt = served["x_test"]
    key = jax.random.PRNGKey(5)
    normals = jax_chain_normals(key, P, NT, num_samples=S)  # 5 samples on 3 shards
    kw = dict(num_samples=S, credible_bounds=True, normals=normals)
    got = rt.predict(xt, mesh=cpu_mesh(), **kw)
    want = single.predict(xt, **kw)
    for a, b in zip(got, want):
        assert a.shape == (NT, P)
        close(a, b, rtol=0, atol=1e-7)
    for a, b in zip(got, rj.predict(xt, num_samples=S, credible_bounds=True, key=key)):
        close(a, b, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_sample_under_mesh(served, model):
    rj, single, rt = served[model]
    xt = served["x_test"]
    normals, noise = np.random.default_rng(7).standard_normal((2, P, S, NT))
    kw = dict(num_samples=S, normals=normals, noise_normals=noise)
    for posterior in (True, False):
        extra = dict(posterior=True) if posterior else dict(p=P)
        got = np.stack(rt.sample(xt, mesh=cpu_mesh(), **extra, **kw))
        assert got.shape == (S, NT, P)
        close(got, np.stack(single.sample(xt, **extra, **kw)), rtol=0, atol=1e-7)
    key = jax.random.PRNGKey(8)
    want = np.stack(rj.sample(xt, posterior=True, num_samples=S, key=key))
    z1, z2 = jax_chain_normals(key, P, NT, num_samples=S, noise=True)
    got = np.stack(rt.sample(xt, posterior=True, num_samples=S, normals=z1, noise_normals=z2,
                             mesh=cpu_mesh()))
    close(got, want, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("posterior", [False, True])
@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_logpdf_under_mesh(served, model, posterior):
    rj, single, rt = served[model]
    x2, y2, _ = chain_data(n=24, p=P, seed=4)
    y2[[2, 5], 1] = np.nan
    with on_mesh():
        got = rt.logpdf(x2, y2, posterior=posterior)
    close(got, single.logpdf(x2, y2, posterior=posterior), rtol=1e-7)
    close(got, rj.logpdf(x2, y2, posterior=posterior), rtol=1e-6)


def test_logpdf_routes_under_mesh(served, monkeypatch):
    # The prior score shards its chain; the sparse posterior score its tail;
    # the dense posterior score runs through the GP core's sharded Obs.
    x2, y2, _ = chain_data(n=24, p=P, seed=4)
    seen = []
    for name in ("_mesh_chain_nll", "_mesh_sparse_posterior_score"):
        real = getattr(TF, name)
        monkeypatch.setattr(TF, name, lambda *a, real=real, name=name, **k: (
            seen.append(name), real(*a, **k))[1])
    import gpar_torch.parallel.dense as TD

    real_dense = TD.sharded_dense_factors
    monkeypatch.setattr(TD, "sharded_dense_factors",
                        lambda *a, **k: (seen.append("dense_obs"), real_dense(*a, **k))[1])
    with on_mesh():
        served["sparse"][2].logpdf(x2, y2)
        served["sparse"][2].logpdf(x2, y2, posterior=True)
        served["dense"][2].logpdf(x2, y2, posterior=True)
    assert seen[0] == "_mesh_chain_nll" and seen[1] == "_mesh_sparse_posterior_score"
    assert set(seen[2:]) == {"dense_obs"}


def test_precompute_under_mesh(served, monkeypatch):
    _, single, rt = served["sparse"]
    xt = served["x_test"]
    normals = np.random.default_rng(9).standard_normal((P, S, NT))
    built = []
    real = TF.make_scan_posterior_factors
    monkeypatch.setattr(TF, "make_scan_posterior_factors",
                        lambda *a, **k: (built.append(1), real(*a, **k))[1])
    rt._factor_cache = None
    assert rt.precompute() is True and len(built) == 1
    with on_mesh():
        assert rt.precompute() is True and len(built) == 2  # a slot made without a mesh is not reused
        got = rt.predict(xt, num_samples=S, normals=normals)
        assert len(built) == 2
    close(got, single.predict(xt, num_samples=S, normals=normals), rtol=0, atol=1e-7)


# -- greedy ----------------------------------------------------------------------


def test_greedy_under_mesh():
    # p = 2 on 3 shards: the positions' 2 and 1 candidates pad 1 and 2
    # copies of the first candidate, whose scores are dropped.  The greedy
    # order puts the noisy signal (column 1) first.
    rng = np.random.default_rng(5)
    x = np.linspace(0.0, 10.0, 40)
    a = np.sin(x) + 0.3 * rng.standard_normal(40)
    y = np.stack([2.0 * a + 0.05 * rng.standard_normal(40), a], axis=1)
    y[rng.permutation(40)[:4], 0] = np.nan
    kw = dict(noise=0.1, compat=False)
    single = TReg(**kw, device="cpu")
    single.fit(x, y, greedy=True, iters=ITERS)
    rt = TReg(**kw, device="cpu")
    with on_mesh():
        rt.fit(x, y, greedy=True, iters=ITERS)
    np.testing.assert_array_equal(rt.order, single.order)
    for got, want in zip(rt.last_greedy_report["positions"], single.last_greedy_report["positions"]):
        assert got["candidates"] == want["candidates"] and len(got["nll"]) == len(want["candidates"])
        close(got["nll"], want["nll"], rtol=1e-7)
    rj = JReg(**kw)
    rj.condition(x, y)
    np.testing.assert_array_equal(rt.order, rj._greedy_order(ITERS))


# -- the graph cache -------------------------------------------------------------


def test_mesh_step_never_replays_a_single_device_graph(monkeypatch):
    # The capture is stubbed out (it needs the card); the keys and steps are
    # the cache's own.
    class Captured:
        capture_s = 1.0

        def __init__(self, step):
            self.step = step

    monkeypatch.setattr(TGr, "GraphedStep", Captured)
    monkeypatch.setattr(TGr, "_CACHE", type(TGr._CACHE)())
    x, y, _ = _data()
    rt = TReg(**_kw("dense"), device="cpu")
    rt.condition(x, y)
    rt._ensure_vars(P)
    names = rt.vs.select(None)
    plan = rt._scan_fit_plan(names)
    x_pad, rows = rt._bucket_fit_inputs(plan)
    zi = torch.zeros((0, plan.m), dtype=torch.float64)
    args = (rt.vs.latent_vector(names), x_pad, rows, zi, torch.zeros((P, 0, plan.s_max)))

    def get(mesh=None):
        return TGr.graphed_step(plan, x_pad.shape[0], 0, torch.float64, "cpu", 2, 1e-9, 10, args,
                                mesh=mesh)

    single = get()
    with on_mesh():
        meshed = get(tconfig.mesh)
        assert get(tconfig.mesh)[0] is meshed[0]  # a hit
        under_mesh_without = get()
    assert single[0] is get()[0]
    assert isinstance(meshed[0], TF.MeshScanStep) and not isinstance(single[0], TF.MeshScanStep)
    assert meshed[0] is not single[0] and under_mesh_without[0] is not single[0]
    assert len(TGr._CACHE) == 3
    # The cached mesh step (a clone serves the capture's warm-up) runs the
    # fit of the eager mesh route.
    step = meshed[0].clone()
    step.load(*args)
    out = TF.run_scan_fit(step, TF.Eager(step), 2)
    with on_mesh():
        rt.fit(x, y, iters=2)
    close(out[1], rt.last_fit_report["layer_nll"], rtol=1e-12)
    assert step.x_parts[0].shape == (32, plan.W)  # 64 rows padded to 96, 3 shards
