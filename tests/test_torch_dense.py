"""The dense GPAR path of gpar_torch (no inducing points, ``x_ind=None``)
against gpar_tpu's, float64, on the CPU.

The benchmark's configuration scaled down with ``x_ind=None`` (p=3, n=100,
NaNs in the later outputs; the GPAR-level cases n=40).  Tolerances:

- ``DenseObs.logpdf``, ``PosteriorGP`` ``mean_vec`` / ``cov`` / ``cov_diag``
  and both dense branches of ``condition``: 1e-10;
- ``_masked_dense_factors`` with masked rows (logpdf, alpha, L) and one
  dense layer's NLL and factors: 1e-10; the on-device jitter ladder gives
  the host ladder's bits;
- the scan fit: at ``iters=0`` the layer NLLs to 1e-10; at ``iters=5`` the
  layer NLLs to 1e-6 and every latent to 1e-6 / 1e-8, against JAX's scan
  fit and against the port's per-layer driver;
- the dense predict tail against JAX's with the same standard normals:
  1e-8, latent or not, unit or non-unit test weights (latent draws through
  their covariance, ``test_torch_common.close_tail``);
- the bucketed forms against the exact-shape forms: 1e-12; the fit at one
  L-BFGS iteration, because the bucket's padded identity rows change the
  factorisation's blocking, so one evaluation agrees to rounding (~3e-16)
  and L-BFGS amplifies it (~2e-12 after five iterations);
- the conditioned GPAR's exact posterior layers and its ``replace=True``
  sampling chain against JAX's: 1e-8.  (The dense log-density and
  resumable inputs of ``GPAR.logpdf`` drive the per-layer driver, held
  against the scan fit above.)
"""

import numpy as np
import pytest

from .test_torch_common import (
    bench_kwargs, chain_data, close, close_tail, jax, jax_chain_normals, jnp, np_, torch,
)

import gpar_tpu.gp.core as JC  # noqa: E402
import gpar_tpu.models.fused as JF  # noqa: E402
import gpar_tpu.ops.linalg as JL  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402
from gpar_tpu.models.regressor import _construct_gpar as j_construct  # noqa: E402

import gpar_torch.gp.core as TC  # noqa: E402
import gpar_torch.models.fused as TF  # noqa: E402
import gpar_torch.ops.linalg as TL  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.config import bucket_rows  # noqa: E402
from gpar_torch.models.regressor import _construct_gpar as t_construct  # noqa: E402

P, ITERS, S, NT = 3, 5, 40, 20
KW = dict(bench_kwargs(), x_ind=None)


def _data():
    x, y, x_test = chain_data(n=100, p=P, seed=0, n_test=NT)
    r = np.random.default_rng(4)
    y[:, 1:][r.uniform(size=(100, P - 1)) < 0.12] = np.nan
    return x, y, x_test


@pytest.fixture(scope="module")
def fits():
    """JAX's dense scan fit at iters=0 and iters=5 (shared by the cases)."""
    x, y, x_test = _data()
    out = dict(x=x, y=y, x_test=x_test)
    for iters in (0, ITERS):
        rj = JReg(**KW)
        rj.fit(x, y, iters=iters)
        assert rj.last_fit_report["fused"] and rj.x_ind is None
        out[iters] = rj
    return out


@pytest.fixture(scope="module")
def models():
    """The same dense prior GPAR in both packages at seeded
    hyperparameters, conditioned on the same data."""
    x, y, _ = chain_data(n=40, p=P, seed=3)
    y[[3, 11, 30], 2] = np.nan
    rj, rt = JReg(**KW), TReg(**KW, device="cpu")
    for reg in (rj, rt):
        reg.condition(x, y)
        reg._ensure_vars(P)
    r = np.random.default_rng(8)
    latents = {k: v + 0.2 * r.standard_normal(np.shape(v)) for k, v in rj.vs.snapshot().items()}
    rj.vs.restore(latents)
    rt.load_latents(latents)
    gj, gt = j_construct(rj, rj.vs, 1, P), t_construct(rt, rt.vs, 1, P)
    return dict(rj=rj, rt=rt, gj=gj, gt=gt, post_j=gj | (rj.x, rj._y_cache, None),
                post_t=gt | (rt.x, rt._y_cache, None))


def test_dense_obs_and_exact_posteriors_match_jax(models):
    # Layer 1's prior (inputs: x and one output column) in both packages.
    (fj, nj), (ft, nt) = models["gj"].layers[1](), models["gt"].layers[1]()
    r = np.random.default_rng(5)
    x1 = np.c_[np.linspace(0.0, 10.0, 30), r.normal(size=30)]
    x2 = np.c_[np.linspace(0.3, 9.7, 12), r.normal(size=12)]
    xs = np.c_[np.linspace(-0.5, 10.5, 9), r.normal(size=9)]
    y1, y2 = r.normal(size=30), r.normal(size=12)
    w1 = r.uniform(0.5, 2.0, 30)

    def run(C, f, noise, x1, w1, y1, x2, y2, xs):
        obs = C.Obs(f(x1, noise / w1), y1)
        fdd = f(x1, noise)
        # A prior conditioned reuses the observations' factor; a posterior
        # conditioned again refactors the union of the data.
        post = C.condition(f, obs)
        again = C.condition(post, C.Obs(post(x2, noise), y2))
        out = [obs.logpdf, fdd.logpdf(y1), fdd.chol()]
        for g in (post, again):
            out += [g.mean_vec(xs), g.cov(xs), g.cov(xs, x2), g.cov_diag(xs), g.alpha]
        return out, (obs, post, again)

    args = (x1, w1, y1, x2, y2, xs)
    want, _ = jax.jit(lambda *a: run(JC, fj, nj, *a))(*map(jnp.asarray, args))
    got, (obs_t, post_t, again_t) = run(TC, ft, nt, *map(torch.as_tensor, args))
    assert isinstance(post_t, TC.PosteriorGP) and post_t.L is obs_t.L
    assert isinstance(again_t, TC.PosteriorGP) and again_t.x_data.shape[0] == 42
    for a, b in zip(got, want):
        close(a, b, rtol=1e-10, atol=1e-12)
    empty = TC.Obs(ft(torch.as_tensor(x1[:0]), nt), torch.as_tensor(y1[:0]))
    assert float(empty.logpdf) == 0.0

    # Observations of one process attached to a structurally different one.
    with pytest.raises(ValueError, match="structurally"):
        TC.condition(post_t, obs_t)


@pytest.mark.parametrize("ladder", ["host", "device"])
def test_masked_dense_factors_match_jax(ladder):
    r = np.random.default_rng(6)
    n = 30
    B = r.normal(size=(n, n + 5))
    K = B @ B.T / n
    mask = (r.uniform(size=n) > 0.3).astype(float)
    noise_w = r.uniform(0.05, 0.2, n)
    res = r.normal(size=n)
    eps = JL.resolve_epsilon(jnp.float64)
    want = JF._masked_dense_factors(*map(jnp.asarray, (K, res, mask, noise_w)), eps)
    jitter = TL.Jitter(ladder)
    got = TF._masked_dense_factors(*map(torch.as_tensor, (K, res, mask, noise_w)), eps, jitter)
    for a, b in zip(got, want):
        close(a, b, rtol=1e-10, atol=1e-13)
    if jitter.count is not None:
        assert int(jitter.count) == 0
        host = TF._masked_dense_factors(*map(torch.as_tensor, (K, res, mask, noise_w)), eps)
        for a, b in zip(got, host):
            np.testing.assert_array_equal(np_(a), np_(b))
    # Masked rows add nothing: the exact density of the observed rows alone.
    o = mask > 0
    Ko = K[np.ix_(o, o)] + np.diag(noise_w[o] + eps)
    _, logdet = np.linalg.slogdet(Ko)
    exact = -0.5 * (o.sum() * np.log(2 * np.pi) + logdet + res[o] @ np.linalg.solve(Ko, res[o]))
    close(got[0], exact, rtol=1e-10)
    assert np.all(np_(got[1])[~o] == 0.0)


def _pair(x, y):
    rj, rt = JReg(**KW), TReg(**KW, device="cpu")
    for r in (rj, rt):
        r.condition(x, y)
        r._ensure_vars(r.p)
    return rj, rt


def test_dense_layer_nll_factors_match_jax(fits):
    rj, rt = _pair(fits["x"], fits["y"])
    rt.load_latents(rj.vs.snapshot())
    names = rt.vs.select(None)
    pj, pt = JF.build_scan_fit_plan(rj, names), TF.build_scan_fit_plan(rt, names)
    assert not pj.sparse and not pt.sparse
    r = np.random.default_rng(7)
    x_aug = np.concatenate([fits["x"][:, None], r.normal(size=(100, P))], axis=1)
    zi_aug = np.zeros((0, P + 1))
    z_ext = np.r_[np.asarray(rj.vs.latent_vector(names)), 0.0]
    xs_t = TF.plan_tensors(pt, torch.float64, "cpu")
    eps = JL.resolve_epsilon(jnp.float64)
    for pi in range(P):
        lin_j = {k: jnp.asarray(v[pi]) for k, v in pj.xs.items()}
        lin_t = {k: v[pi] for k, v in xs_t.items()}
        nll_j, (K_j, alpha_j) = JF._layer_nll_factors(
            pj, lin_j, jnp.asarray(z_ext), jnp.asarray(x_aug), jnp.asarray(zi_aug), eps)
        nll_t, (K_t, alpha_t) = TF._layer_nll_factors(
            pt, lin_t, torch.as_tensor(z_ext), torch.as_tensor(x_aug), torch.as_tensor(zi_aug))
        close(nll_t, nll_j, rtol=1e-10)
        close(K_t, K_j, rtol=1e-10, atol=1e-14)
        close(alpha_t, alpha_j, rtol=1e-10, atol=1e-10)
        est_j, none_j = JF._est_from_factors(pj, (K_j, alpha_j))
        est_t, none_t = TF._est_from_factors(pt, (K_t, alpha_t))
        assert none_j is None and none_t is None
        close(est_t, est_j, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("iters", [0, ITERS])
def test_dense_scan_fit_matches_jax_scan_fit(fits, iters):
    rj = fits[iters]
    rt = TReg(**KW, device="cpu")
    rt.fit(fits["x"], fits["y"], iters=iters)
    rep, jrep = rt.last_fit_report, rj.last_fit_report
    assert rep["fused"] is True and rep["graph_replays"] == 0
    assert rep["layer_iters"].tolist() == np.asarray(jrep["layer_iters"]).tolist()
    if iters == 0:
        close(rep["layer_nll"], jrep["layer_nll"], rtol=1e-10)
        close(rep["layer_nll0"], jrep["layer_nll0"], rtol=1e-10)
        return
    close(rep["layer_nll"], jrep["layer_nll"], rtol=1e-6)
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    assert list(sj) == list(st)
    for k in sj:
        close(st[k], sj[k], rtol=1e-6, atol=1e-8)


def test_dense_scan_fit_matches_per_layer_driver(fits):
    a, b = TReg(**KW, device="cpu"), TReg(**KW, device="cpu")
    a.fit(fits["x"], fits["y"], iters=ITERS)
    b.fit(fits["x"], fits["y"], iters=ITERS, fused=False)
    assert a.last_fit_report["fused"] and not b.last_fit_report["fused"]
    close(a.last_fit_report["layer_nll"], b.last_fit_report["layer_nll"], rtol=1e-6)
    close(a.last_fit_report["layer_nll0"], b.last_fit_report["layer_nll0"], rtol=1e-6)
    sa, sb = a.vs.snapshot(), b.vs.snapshot()
    for k in sb:
        close(sa[k], sb[k], rtol=1e-6, atol=1e-8)
    close(a.last_fit_report["layer_nll"], fits[ITERS].last_fit_report["layer_nll"], rtol=1e-6)


def _tails(fits):
    rj = fits[ITERS]
    rt = TReg(**KW, device="cpu")
    rt.condition(fits["x"], fits["y"])
    rt.load_latents(rj.vs.snapshot())
    names = rt.vs.select(None)
    return rj, rt, names, JF.build_scan_fit_plan(rj, names), TF.build_scan_fit_plan(rt, names)


@pytest.mark.parametrize("unit_w", [True, False])
@pytest.mark.parametrize("latent", [False, True])
def test_dense_predict_tail_matches_jax(fits, latent, unit_w):
    rj, rt, names, pj, pt = _tails(fits)
    key = jax.random.PRNGKey(11)
    xt = fits["x_test"][:, None]
    w = np.ones((P, NT)) if unit_w else np.random.default_rng(12).uniform(0.5, 2.0, (P, NT))
    batch_j, mean_j = JF.make_scan_predict_tail(pj, None, latent)(
        rj.vs.latent_vector(names), rj.x, jnp.asarray(xt), jnp.asarray(w), jax.random.split(key, S))
    normals = jax_chain_normals(key, P, NT, num_samples=S)
    batch_t, mean_t = TF.make_scan_predict_tail(pt, None, latent)(
        rt.vs.latent_vector(names), rt.x, torch.as_tensor(xt), torch.as_tensor(w), torch.as_tensor(normals))
    assert tuple(batch_t.shape) == (S, NT, P) and tuple(mean_t.shape) == (NT, P)
    close_tail((batch_t, mean_t), (batch_j, mean_j), normals, latent)


def test_dense_bucketed_forms_equal_exact_forms(fits):
    _, rt, names, _, pt = _tails(fits)
    z0 = rt.vs.latent_vector(names)
    x_pad, rows = rt._bucket_fit_inputs(pt)
    assert x_pad.shape[0] == 128
    exact = TF.make_scan_fit_body(pt, None, 1, 1e-9, 10)(z0, rt.x)
    bucketed = TF.make_scan_fit_body(pt, None, 1, 1e-9, 10, rows_traced=True)(z0, x_pad, rows)
    for a, b in zip(bucketed, exact):
        close(a, b, rtol=1e-12, atol=1e-13)

    z = exact[0]
    normals = torch.as_tensor(np.random.default_rng(2).standard_normal((P, S, NT)))
    xt = torch.as_tensor(fits["x_test"][:, None])
    w = torch.ones(P, NT, dtype=torch.float64)
    want = TF.make_scan_predict_tail(pt, None, False)(z, rt.x, xt, w, normals)
    nt_b = bucket_rows(NT)
    pad = nt_b - NT
    mt = torch.as_tensor((np.arange(nt_b) < NT).astype(float))
    got = TF.make_scan_predict_tail(pt, None, False, rows_traced=True)(
        z, x_pad, torch.nn.functional.pad(xt, (0, 0, 0, pad)), torch.nn.functional.pad(w, (0, pad), value=1.0),
        torch.nn.functional.pad(normals, (0, pad)), rows, mt)
    close(got[0][:, :NT], want[0], rtol=1e-12, atol=1e-13)
    close(got[1][:NT], want[1], rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("layer", range(P))
def test_dense_posterior_layers_match_jax(models, layer):
    fj, nj = models["post_j"].layers[layer]()
    ft, nt = models["post_t"].layers[layer]()
    assert isinstance(ft, TC.PosteriorGP)
    close(nt, nj, rtol=1e-12)
    xs = np.random.default_rng(layer).normal(size=(11, 1 + layer)) + np.r_[5.0, [0.0] * layer]
    close(ft.mean(torch.as_tensor(xs)), fj.mean(jnp.asarray(xs)), rtol=1e-8, atol=1e-10)
    close(ft.cov(torch.as_tensor(xs)), fj.cov(jnp.asarray(xs)), rtol=1e-8, atol=1e-10)
    close(ft.cov_diag(torch.as_tensor(xs)), fj.cov_diag(jnp.asarray(xs)), rtol=1e-8, atol=1e-10)


def test_dense_replace_chain_matches_jax(models):
    post_j, post_t = models["post_j"], models["post_t"]
    assert post_t.replace and not post_t.sparse
    xs = np.linspace(0.5, 9.5, 13)[:, None]
    w = np.ones((13, P))
    key = jax.random.PRNGKey(11)
    want = post_j.sample(jnp.asarray(xs), jnp.asarray(w), key=key)
    got = post_t.sample(torch.as_tensor(xs), torch.as_tensor(w), torch.as_tensor(jax_chain_normals(key, P, 13)))
    close(got, want, rtol=1e-8, atol=1e-10)


def test_dense_step_bodies_read_nothing_back_to_the_host():
    # A CUDA graph capture refuses a host read; on the meta device every
    # read of a value raises, so the dense step's bodies (the (rows, rows)
    # factorisation through the on-device ladder included) are run there.
    x, y, _ = _data()
    rt = TReg(**KW, device="cpu")
    rt.condition(x, y)
    rt._ensure_vars(P)
    plan = TF.build_scan_fit_plan(rt, rt.vs.select(None))
    step = TF.ScanStep(plan, 128, 0, torch.float64, "meta")
    assert tuple(step.zi_aug.shape) == (0, plan.W)
    run = TF.Eager(step)
    for name in step.BODIES:
        run(name)
