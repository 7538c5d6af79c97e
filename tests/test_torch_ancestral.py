"""Per-sample ancestral sampling of gpar_torch (``replace=False`` prediction,
posterior and prior ``sample``) against gpar_tpu's, float64, on the CPU.

The benchmark's configuration scaled down (p=3, n=60, 8 inducing points or
none, NaNs in the later outputs) with ``replace=False``, at the latents of
a short JAX fit carried across with ``load_latents``; every draw from the
same standard normals (JAX's key stream, ``jax_chain_normals``).
Tolerances:

- the Gram with a sample axis (plain version) against ``jax.vmap`` of the
  JAX ``gram``: 1e-12;
- ``psd_sample_factor_batched``: ``F F^T`` to 1e-12 everywhere, the
  factors to 1e-10 where the first jitter rung holds and to 1e-6 / 1e-8
  where a later rung is taken (the jittered matrix has condition ~1 /
  jitter there);
- ``resolve_sample_chunk``: equal; a chunked tail equals the unchunked
  one bit for bit;
- ``make_scan_posterior_factors``: 1e-10, and the per-layer iterator the
  tail consumes (``posterior_factor_layers``) equal to it bit for bit;
- the ancestral tail, ``predict``/``fit_predict``, the route whose dense
  stack does not fit, and ``sample``: draws, means and bounds to 1e-8,
  latent draws included.  A latent posterior covariance can be
  near-singular (condition ~1 / jitter), and then the two packages'
  factors differ by rounding in its near-null directions, a difference
  that ``replace=False`` would feed into every later layer.  So the test
  inputs are 12 points spread over the input range: layer 0's latent test
  covariance has eigenvalues 0.052-0.56 (sparse) and 0.0082-0.032 (dense),
  and the latent draws agree to 1.2e-13.
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jax_chain_normals, jnp, np_, torch
from .test_torch_kernels import _JaxFW
from .torch_cases import CASES, TorchFW

import gpar_tpu  # noqa: E402
import gpar_tpu.models.fused as JF  # noqa: E402
import gpar_tpu.ops.kernels as JK  # noqa: E402
import gpar_tpu.ops.linalg as JL  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
import gpar_torch.ops.kernels as TK  # noqa: E402
import gpar_torch.ops.linalg as TL  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402

P, N, NT, S, ITERS = 3, 60, 12, 8, 2
TOL = 1e-8
SPARSE = dict(bench_kwargs(n_ind=8), replace=False)
DENSE = dict(SPARSE, x_ind=None)


def _data():
    x, y, x_test = chain_data(n=N, p=P, seed=0, n_test=NT)
    r = np.random.default_rng(4)
    y[:, 1:][r.uniform(size=(N, P - 1)) < 0.12] = np.nan
    return x, y, x_test


@pytest.fixture(scope="module")
def fits():
    """A short JAX fit of the sparse and the dense model (their latents are
    the test's hyperparameters)."""
    x, y, x_test = _data()
    out = dict(x=x, y=y, x_test=x_test)
    for name, kw in (("sparse", SPARSE), ("dense", DENSE)):
        rj = JReg(**kw)
        rj.fit(x, y, iters=ITERS)
        out[name] = (kw, rj)
    return out


def _port(fits, model, **over):
    """The port's regressor on the same data at the JAX fit's latents."""
    kw, rj = fits[model]
    kw = dict(kw, **over)
    rt = TReg(**kw, device="cpu")
    rt.condition(fits["x"], fits["y"])
    rt.load_latents(rj.vs.snapshot())
    return rt


# -- the Gram with a sample axis ----------------------------------------------------


@pytest.mark.parametrize("layout", ["shared-left", "shared-right", "both"])
@pytest.mark.parametrize("case", ["layer-kernel-gated", "periodic", "select", "product", "rq-product"])
def test_batched_gram_matches_jax_vmap(case, layout):
    # "rq-product" is refused by the analyser: the batched plain recursion.
    build, d = CASES[case]
    tj, tt = build(_JaxFW(np.float64)), build(TorchFW(np.float64))
    r = np.random.default_rng(9)
    xb, yb = r.normal(size=(4, 7, d)), r.normal(size=(4, 5, d))
    x2, y2 = r.normal(size=(7, d)), r.normal(size=(5, d))
    args = {"shared-left": (x2, yb), "shared-right": (xb, y2), "both": (xb, yb)}[layout]
    axes = {"shared-left": (None, 0), "shared-right": (0, None), "both": (0, 0)}[layout]
    want = jax.vmap(lambda a, b: JK.gram(tj, a, b), in_axes=axes)(*map(jnp.asarray, args))
    with torch.no_grad():
        got = TK.gram(tt, *map(torch.as_tensor, args))
    assert tuple(got.shape) == (4, 7, 5)
    close(got, want, rtol=1e-12, atol=1e-12)


def test_batched_gram_is_forward_only():
    # The Gram with a sample axis was forward only; it now has a backward
    # (the batched backward kernel; its plain version here): the gradient of
    # the batched Gram equals the gradients of the per-sample Grams.
    build, d = CASES["layer-kernel-gated"]
    tree = build(TorchFW(np.float64))
    xb = torch.randn(3, 6, d, dtype=torch.float64, requires_grad=True)
    y2 = torch.randn(5, d, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 6, 5, dtype=torch.float64)
    gx, gy = torch.autograd.grad(torch.sum(TK.gram(tree, xb, y2) * w), (xb, y2))
    want = [torch.autograd.grad(torch.sum(TK.gram(tree, xb[s], y2) * w[s]), (xb, y2))
            for s in range(3)]
    close(gx, sum(g[0] for g in want), rtol=1e-12, atol=1e-12)
    close(gy, sum(g[1] for g in want), rtol=1e-12, atol=1e-12)


# -- the batched sampling factor ----------------------------------------------------


def test_psd_sample_factor_batched_matches_jax():
    # One element per rung: the first holds; the second rung (1e-9) holds;
    # only the relative rung (1e-6 * 100) holds; none does (eigh).
    K = np.stack([
        np.array([[2.0, 0.3], [0.3, 1.0]]),
        np.array([[1.0, 0.3], [0.3, 0.09 - 1e-10]]),
        np.array([[100.0, 0.0], [0.0, -1e-5]]),
        np.array([[1.0, 0.0], [0.0, -1.0]]),
    ])
    got = np_(TL.psd_sample_factor_batched(torch.as_tensor(K)))
    want = np.asarray(JL.psd_sample_factor_batched(jnp.asarray(K)))
    for i, (g, w) in enumerate(zip(got, want)):
        close(g @ g.T, w @ w.T, rtol=0, atol=1e-12)
        close(g, w, **(dict(rtol=1e-10, atol=1e-14) if i == 0 else dict(rtol=1e-6, atol=1e-8)))
    # The rung each took: F F^T = K + jitter I (eigh clamps instead).
    jitter = np.diagonal(np.einsum("sij,skj->sik", got, got) - K, axis1=1, axis2=2)[:, 0]
    close(jitter[:3], [1e-12, 1e-9, 1e-4], rtol=1e-3)


# -- chunking -----------------------------------------------------------------------


@pytest.mark.parametrize("chunk", ["auto", None, 0, 7])
def test_resolve_sample_chunk_matches_jax(chunk):
    for num_samples in (1, 16, 100):
        for n_test in (64, 1216):
            for tdt, jdt in ((torch.float32, np.float32), (torch.float64, np.float64)):
                for budget in (2 << 30, 1 << 20, 1 << 10):
                    got = TF.resolve_sample_chunk(chunk, num_samples, n_test, tdt, budget)
                    assert got == JF.resolve_sample_chunk(chunk, num_samples, n_test, jdt, budget)
    assert TF.resolve_sample_chunk("auto", 100, 1216, torch.float32, 2 << 30) == 90


@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_chunked_tail_equals_unchunked(fits, model):
    rt = _port(fits, model)
    names = rt.vs.select(None)
    plan = rt._scan_fit_plan(names)
    z = rt.vs.latent_vector(names)
    layers = TF.posterior_factor_layers(plan, rt.x_ind)
    xt = torch.as_tensor(fits["x_test"][:, None])
    w = torch.ones(P, NT, dtype=torch.float64)
    r = np.random.default_rng(1)
    z1, z2 = (torch.as_tensor(r.standard_normal((P, S, NT))) for _ in range(2))
    outs = [TF.make_scan_ancestral_tail(plan, True, sample_chunk=c)(z, layers(z, rt.x), xt, w, z1, z2)
            for c in (None, 3)]
    np.testing.assert_array_equal(np_(outs[1]), np_(outs[0]))


# -- posterior factors and the tails ------------------------------------------------


def _plans(fits, model, impute=True):
    rt = _port(fits, model, impute=impute)
    rj = JReg(**dict(fits[model][0], impute=impute))
    rj.condition(fits["x"], fits["y"])
    rj._ensure_vars(P)
    rj.vs.restore(fits[model][1].vs.snapshot())
    names = rt.vs.select(None)
    assert names == rj.vs.select(None)
    return rj, rt, names, JF.build_scan_fit_plan(rj, names), TF.build_scan_fit_plan(rt, names)


@pytest.mark.parametrize("impute", [True, False])
@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_posterior_factors_match_jax(fits, model, impute):
    rj, rt, names, pj, pt = _plans(fits, model, impute)
    assert not pt.replace and pt.impute == impute
    want = JF.make_scan_posterior_factors(pj, rj.x_ind)(rj.vs.latent_vector(names), rj.x)
    got = TF.make_scan_posterior_factors(pt, rt.x_ind)(rt.vs.latent_vector(names), rt.x)
    assert sorted(got) == sorted(want) == (
        ["LB", "Lm", "beta", "zi_aug"] if model == "sparse" else ["L", "alpha", "x_aug"])
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        close(got[k], want[k], rtol=1e-10, atol=1e-12)
    # The per-layer iterator gives the same factors.
    layers = TF.posterior_factor_layers(pt, rt.x_ind)(rt.vs.latent_vector(names), rt.x)
    with torch.no_grad():
        for pi, fac in enumerate(layers):
            for k in fac:
                np.testing.assert_array_equal(np_(fac[k]), np_(got[k][pi]))


@pytest.mark.parametrize("unit_w", [True, False])
@pytest.mark.parametrize("latent", [False, True])
@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_ancestral_tail_matches_jax(fits, model, latent, unit_w):
    rj, rt, names, pj, pt = _plans(fits, model)
    key = jax.random.PRNGKey(11)
    xt = fits["x_test"][:, None]
    w = np.ones((P, NT)) if unit_w else np.random.default_rng(12).uniform(0.5, 2.0, (P, NT))
    zj = rj.vs.latent_vector(names)
    fac_j = JF.make_scan_posterior_factors(pj, rj.x_ind)(zj, rj.x)
    want = JF.make_scan_ancestral_tail(pj, latent)(
        zj, fac_j, jnp.asarray(xt), jnp.asarray(w), jax.random.split(key, S))
    z1, z2 = jax_chain_normals(key, P, NT, num_samples=S, noise=True)
    zt = rt.vs.latent_vector(names)
    fac_t = TF.posterior_factor_layers(pt, rt.x_ind)(zt, rt.x)
    got = TF.make_scan_ancestral_tail(pt, latent)(
        zt, fac_t, torch.as_tensor(xt), torch.as_tensor(w), torch.as_tensor(z1), torch.as_tensor(z2))
    assert tuple(got.shape) == (S, NT, P)
    close(got, want, rtol=TOL, atol=1e-10)


# -- the estimator ------------------------------------------------------------------


def _reduce(batch):
    return batch.mean(axis=0), np.percentile(batch, 2.5, axis=0), np.percentile(batch, 97.5, axis=0)


@pytest.mark.parametrize("latent", [False, True])
@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_predict_matches_jax(fits, model, latent):
    rj, rt = fits[model][1], _port(fits, model)
    key = jax.random.PRNGKey(5)
    want = rj.predict(fits["x_test"], num_samples=S, latent=latent, credible_bounds=True, key=key)
    z1, z2 = jax_chain_normals(key, P, NT, num_samples=S, noise=True)
    got = rt.predict(fits["x_test"], num_samples=S, latent=latent, credible_bounds=True,
                     normals=z1, noise_normals=z2)
    for a, b in zip(got, want):
        assert a.shape == (NT, P)
        close(a, b, rtol=TOL, atol=1e-10)


@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_fit_predict_matches_jax(fits, model):
    # No L-BFGS iteration: both packages predict at the same initial
    # latents (a fit's own parity is held in test_torch_fused/_dense).
    kw = fits[model][0]
    key = jax.random.PRNGKey(6)
    want = JReg(**kw).fit_predict(fits["x"], fits["y"], fits["x_test"], num_samples=S,
                                  credible_bounds=True, key=key, iters=0)
    z1 = jax_chain_normals(jax.random.split(key)[1], P, NT, num_samples=S)
    rt = TReg(**kw, device="cpu")
    got = rt.fit_predict(fits["x"], fits["y"], fits["x_test"], num_samples=S, credible_bounds=True,
                         normals=z1, iters=0)
    for a, b in zip(got, want):
        close(a, b, rtol=TOL, atol=1e-10)
    # fit_predict is fit, then predict.
    again = rt.predict(fits["x_test"], num_samples=S, credible_bounds=True, normals=z1)
    for a, b in zip(got, again):
        close(a, b, rtol=0)


def test_dense_route_without_the_stack_matches_jax_unrolled_route(fits, monkeypatch):
    # A stack "too large" for a few bytes: JAX falls back to its unrolled
    # per-sample chain; the port never stacks, it computes each layer's
    # factors in the tail.
    monkeypatch.setattr(gpar_tpu.config, "posterior_cache_max_bytes", 8)

    def no_stack(*a, **k):
        raise AssertionError("the stacked factors were built")

    monkeypatch.setattr(TF, "make_scan_posterior_factors", no_stack)
    rj, rt = fits["dense"][1], _port(fits, "dense")
    key = jax.random.PRNGKey(7)
    want = rj.predict(fits["x_test"], num_samples=S, credible_bounds=True, key=key)
    got = rt.predict(fits["x_test"], num_samples=S, credible_bounds=True,
                     normals=jax_chain_normals(key, P, NT, num_samples=S))
    for a, b in zip(got, want):
        close(a, b, rtol=TOL, atol=1e-10)


@pytest.mark.parametrize("replace", [False, True])
def test_posterior_sample_matches_jax(fits, replace):
    rt = _port(fits, "sparse", replace=replace)
    rj = JReg(**dict(fits["sparse"][0], replace=replace))
    rj.condition(fits["x"], fits["y"])
    rj._ensure_vars(P)
    rj.vs.restore(fits["sparse"][1].vs.snapshot())
    key = jax.random.PRNGKey(8)
    want = rj.sample(fits["x_test"], posterior=True, num_samples=S, key=key)
    got = rt.sample(fits["x_test"], posterior=True, num_samples=S,
                    normals=jax_chain_normals(key, P, NT, num_samples=S))
    assert isinstance(got, list) and len(got) == S and got[0].shape == (NT, P)
    close(np.stack(got), np.stack(want), rtol=TOL, atol=1e-10)
    one = rt.sample(fits["x_test"], posterior=True, normals=jax_chain_normals(key, P, NT, num_samples=1))
    assert isinstance(one, np.ndarray) and one.shape == (NT, P)


def test_prior_sample_matches_jax(fits):
    rj, rt = fits["sparse"][1], _port(fits, "sparse")
    key = jax.random.PRNGKey(9)
    want = rj.sample(fits["x_test"], p=P, num_samples=S, key=key)
    got = rt.sample(fits["x_test"], p=P, num_samples=S,
                    normals=jax_chain_normals(key, P, NT, num_samples=S))
    close(np.stack(got), np.stack(want), rtol=TOL, atol=1e-10)
    with pytest.raises(ValueError, match="`p`"):
        rt.sample(fits["x_test"])
