"""gpar_torch.models.gpar against gpar_tpu.models.gpar.

Both packages condition the same GPAR (the benchmark's configuration,
scaled down, at the same seeded hyperparameters) on the same data; the
per-layer sparse posteriors, the log-density, the resumable inputs and
the ancestral sampling chain (fed the JAX package's own standard normals)
agree to 1e-8 relative in float64.
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jax_chain_normals, jnp, np_, torch

import gpar_tpu.models.gpar as JG  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402
from gpar_tpu.models.regressor import _construct_gpar as j_construct  # noqa: E402

import gpar_torch.models.gpar as TG  # noqa: E402
from gpar_torch.models.regressor import GPARRegressor as TReg  # noqa: E402
from gpar_torch.models.regressor import _construct_gpar as t_construct  # noqa: E402

P = 3


@pytest.fixture(scope="module")
def models():
    """The same prior GPAR in both packages at seeded hyperparameters,
    conditioned on the same data."""
    x, y, _ = chain_data(n=40, p=P, seed=3)
    kw = bench_kwargs(n_ind=6)
    rj, rt = JReg(**kw), TReg(**kw, device="cpu")
    rj.condition(x, y)
    rt.condition(x, y)
    rj._ensure_vars(P)
    rt._ensure_vars(P)
    r = np.random.default_rng(8)
    latents = {k: v + 0.2 * r.standard_normal(np.shape(v)) for k, v in rj.vs.snapshot().items()}
    rj.vs.restore(latents)
    rt.load_latents(latents)
    gj, gt = j_construct(rj, rj.vs, 1, P), t_construct(rt, rt.vs, 1, P)
    post_j = gj | (rj.x, rj._y_cache, None)
    post_t = gt | (rt.x, rt._y_cache, None)
    return dict(rj=rj, rt=rt, gj=gj, gt=gt, post_j=post_j, post_t=post_t)


@pytest.mark.parametrize("layer", range(P))
def test_posterior_layers_match_jax(models, layer):
    fj, nj = models["post_j"].layers[layer]()
    ft, nt = models["post_t"].layers[layer]()
    close(nt, nj, rtol=1e-12)
    xs = np.random.default_rng(layer).normal(size=(11, 1 + layer)) + np.r_[5.0, [0.0] * layer]
    close(ft.mean(torch.as_tensor(xs)), fj.mean(jnp.asarray(xs)), rtol=1e-8, atol=1e-10)
    close(ft.cov(torch.as_tensor(xs)), fj.cov(jnp.asarray(xs)), rtol=1e-8, atol=1e-10)
    close(ft.cov_diag(torch.as_tensor(xs)), fj.cov_diag(jnp.asarray(xs)), rtol=1e-8, atol=1e-10)


def test_logpdf_and_resumable_inputs_match_jax(models):
    rj, rt, gj, gt = models["rj"], models["rt"], models["gj"], models["gt"]
    close(gt.logpdf(rt.x, rt._y_cache, None), gj.logpdf(rj.x, rj._y_cache, None), rtol=1e-10)
    # The resumable-inputs path behind fit(fix=True): inputs after the first
    # two layers, and the last-layer term from them.
    xj, zj = gj.logpdf(rj.x, rj._y_cache, None, outputs=[0, 1], return_inputs=True)
    xt, zt = gt.logpdf(rt.x, rt._y_cache, None, outputs=[0, 1], return_inputs=True)
    close(xt, xj, rtol=1e-9, atol=1e-11)
    close(zt, zj, rtol=1e-9, atol=1e-11)
    lj = gj.logpdf(xj, rj._y_cache, None, only_last_layer=True, outputs=[2], x_ind=zj)
    lt = gt.logpdf(xt, rt._y_cache, None, only_last_layer=True, outputs=[2], x_ind=zt)
    close(lt, lj, rtol=1e-10)


@pytest.mark.parametrize("replace", [True, False])
def test_sample_chain_with_jax_normals_matches_jax(models, replace):
    post_j, post_t = models["post_j"], models["post_t"]
    post_j.replace = post_t.replace = replace
    try:
        xs = np.linspace(0.5, 9.5, 13)[:, None]
        w = np.ones((13, P))
        key = jax.random.PRNGKey(11)
        want = post_j.sample(jnp.asarray(xs), jnp.asarray(w), key=key)
        normals = torch.as_tensor(jax_chain_normals(key, P, 13))
        got = post_t.sample(torch.as_tensor(xs), torch.as_tensor(w), normals)
        close(got, want, rtol=1e-8, atol=1e-10)
    finally:
        post_j.replace = post_t.replace = True


def test_routing_helpers_match_jax():
    r = np.random.default_rng(4)
    y = r.normal(size=(12, 3))
    y[[2, 7], 2] = np.nan
    y[[5], 1] = np.nan
    w = r.uniform(0.5, 2.0, size=(12, 3))
    for keep in (False, True):
        for (yj, wj, mj), (yt, wt, mt) in zip(
            JG.per_output(y, w, keep=keep), TG.per_output(y, w, keep=keep)
        ):
            np.testing.assert_array_equal(mt, mj)
            close(yt, yj, rtol=0)
            close(wt, wj, rtol=0)
    x = r.normal(size=(12, 2))
    mask = r.uniform(size=12) > 0.4
    upd = r.normal(size=(int(mask.sum()), 2))
    close(TG.merge(torch.as_tensor(x), torch.as_tensor(upd), mask),
          JG.merge(jnp.asarray(x), jnp.asarray(upd), mask), rtol=0)
    close(TG.take_rows(torch.as_tensor(x), mask), JG.take_rows(jnp.asarray(x), mask), rtol=0)
    for sel in (None, [0, 2], [3]):
        assert list(TG.last(range(3), sel)) == list(JG.last(range(3), sel))
