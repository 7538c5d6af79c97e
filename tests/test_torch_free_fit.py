"""The joint fit ``fit(fix=False)`` of gpar_torch (``models/fused.py``'s
``make_scan_free_fit_body`` and the per-layer driver's full-chain
objective) against gpar_tpu's, float64, on the CPU.

The benchmark's configuration scaled down (p=3, 40 rows, NaNs in the later
outputs; sparse with 8 inducing points and dense).  Tolerances:

- position ``pi``'s objective, the NLL of the chain of layers ``0..pi``,
  and its gradient at given latents against JAX's free-body objective
  (its own ``_layer_nll_factors``, ``_est_from_factors`` and
  ``_augment_cols`` under the contribution gate) and ``jax.grad``: 1e-10,
  at every position; that objective at JAX's fitted latents against the
  JAX body's reported last-position NLL: 1e-10;
- the whole fit at ``iters=3``: latents and ``last_fit_report`` against
  JAX's at 1e-6 (both run the same L-BFGS decisions on the same objective,
  in another summation order);
- the scan fit against the port's per-layer driver: 1e-6; bucketed against
  exact rows at one L-BFGS iteration: 1e-10 (the bucket's padded identity
  rows change the factorisations' blocking);
- the last position's NLL against minus the score of the whole chain
  (``compat=False``): 1e-12, and the fixed fit's summed layer NLLs
  likewise.
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jnp, torch

import gpar_tpu.models.fused as JF  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.params.lbfgs import new_stats  # noqa: E402

P, ITERS = 3, 3

REPORT_KEYS = {"layer_nll0", "layer_nll", "layer_iters", "fused", "wall_clock_s", "host_syncs",
               "ladder_escalations", "graph_replays"}


def _data():
    x, y, _ = chain_data(n=40, p=P, seed=0)
    r = np.random.default_rng(4)
    y[:, 1:][r.uniform(size=(40, P - 1)) < 0.12] = np.nan
    return x, y


def _kw(sparse, **kw):
    out = dict(bench_kwargs(n_ind=8), **kw)
    if not sparse:
        out["x_ind"] = None
    return out


@pytest.fixture(scope="module")
def fits():
    """JAX's and the port's scan free fits at ITERS iterations."""
    x, y = _data()
    out = {}
    for sparse in (True, False):
        rj, rt = JReg(**_kw(sparse)), TReg(**_kw(sparse), device="cpu")
        for reg in (rj, rt):
            reg.fit(x, y, fix=False, iters=ITERS)
        out[sparse] = rj, rt
    return out


def _jax_objective(pj, x_ind, x):
    """Position ``pi``'s objective as JAX's free body composes it
    (``gpar_tpu/models/fused.py:1318-1345``), with its value and gradient:
    ``fn(z_sub, z_all, gather, gate)``, all p layers from the raw inputs,
    each layer's NLL under the gate ``gate[l] = l <= pi``."""
    xs = {k: jnp.asarray(v) for k, v in pj.xs.items()}
    W, m = pj.W, pj.m
    eps = JF.resolve_epsilon(jnp.float64)

    def obj(z_sub, z_all, gather, gate):
        z_ext = jnp.concatenate([z_all, jnp.zeros((1,), z_all.dtype)])
        z_full = z_ext.at[gather].set(z_sub)
        x_aug = jnp.concatenate([x, jnp.zeros((x.shape[0], W - m))], axis=1)
        zi = jnp.zeros((0, m)) if x_ind is None else jnp.asarray(x_ind)
        zi_aug = jnp.concatenate([zi, jnp.zeros((zi.shape[0], W - m))], axis=1)
        total = 0.0
        for l in range(pj.p):
            lin = {k: v[l] for k, v in xs.items()}
            nll, factors = JF._layer_nll_factors(pj, lin, z_full, x_aug, zi_aug, eps)
            est_rows, est_ind = JF._est_from_factors(pj, factors)
            x_aug, zi_aug = JF._augment_cols(pj, lin, est_rows, est_ind, x_aug, zi_aug)
            total = total + gate[l] * nll
        return total

    return jax.jit(jax.value_and_grad(obj))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_position_objective_and_gradient_match_jax(fits, sparse):
    rj, _ = fits[sparse]
    x, y = _data()
    rt = TReg(**_kw(sparse), device="cpu")
    rt.condition(x, y)
    rt._ensure_vars(P)
    names = rt.vs.select(None)
    pt = TF.build_scan_fit_plan(rt, names)
    pj = JF.build_scan_fit_plan(rj, names)
    prefix = TF._prefix_gather(pt)
    offsets, _ = TF._name_offsets(rt.vs, names)
    for pi in range(P):
        want = sorted(i for nm in rt.vs.select([f"{l}/*" for l in range(pi + 1)])
                      for i in range(offsets[nm][0], sum(offsets[nm])))
        assert sorted(prefix[pi][prefix[pi] < pt.n_z]) == want

    fn = _jax_objective(pj, rj.x_ind, jnp.asarray(x[:, None]))

    def jax_at(z_all, pi):
        gate = (np.arange(P) <= pi).astype(np.float64)
        return fn(jnp.asarray(np.r_[z_all, 0.0][prefix[pi]]), jnp.asarray(z_all), prefix[pi], gate)

    # The reconstruction is the JAX body's objective: at JAX's fitted
    # latents the last position's gives the body's reported NLL.
    z_fit = rj.vs.latent_vector(names)
    close(jax_at(np.asarray(z_fit), P - 1)[0], rj.last_fit_report["layer_nll"][-1], rtol=1e-10)

    r = np.random.default_rng(9)
    z_init = rt.vs.latent_vector(names).numpy()
    z_all = z_init + 0.2 * r.standard_normal(z_init.shape)
    x_t = torch.as_tensor(x[:, None])
    xs, _ = TF._serving_inputs(pt, torch.as_tensor(z_all), x_t, None, False)
    zi = TF._inducing(rt.x_ind, 1, torch.float64, "cpu")
    for pi in range(P):
        fj, gj = jax_at(z_all, pi)
        zt = torch.as_tensor(np.r_[z_all, 0.0][prefix[pi]]).requires_grad_(True)
        z_full = torch.as_tensor(np.r_[z_all, 0.0]).index_put((torch.as_tensor(prefix[pi]),), zt)
        ft = TF._chain_nll(pt, z_full, xs, x_t, zi, pi + 1)
        (gt,) = torch.autograd.grad(ft, zt)
        close(ft, fj, rtol=1e-10)
        close(gt, gj, rtol=1e-10, atol=1e-10 * float(np.max(np.abs(np.asarray(gj)))))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_free_fit_matches_jax(fits, sparse):
    rj, rt = fits[sparse]
    rep_j, rep_t = rj.last_fit_report, rt.last_fit_report
    assert REPORT_KEYS <= set(rep_t) and rep_t["fused"] and rep_t["graph_replays"] == 0
    for k in ("layer_nll", "layer_nll0"):
        close(rep_t[k], rep_j[k], rtol=1e-6)
    np.testing.assert_array_equal(rep_t["layer_iters"], rep_j["layer_iters"])
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    assert sorted(sj) == sorted(st)
    for k in sj:
        close(st[k], sj[k], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_scan_free_fit_matches_per_layer_driver(fits, sparse):
    _, rt = fits[sparse]
    x, y = _data()
    rd = TReg(**_kw(sparse), device="cpu")
    rd.fit(x, y, fix=False, iters=ITERS, fused=False)
    assert not rd.last_fit_report["fused"]
    close(rd.last_fit_report["layer_nll"], rt.last_fit_report["layer_nll"], rtol=1e-6)
    close(rd.last_fit_report["layer_nll0"], rt.last_fit_report["layer_nll0"], rtol=1e-6)
    sd, st = rd.vs.snapshot(), rt.vs.snapshot()
    for k in sd:
        close(st[k], sd[k], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_bucketed_free_fit_matches_exact_rows(sparse):
    x, y = _data()
    out = []
    for bucketed in (True, False):
        rt = TReg(**_kw(sparse), device="cpu")
        rt.condition(x, y)
        rt._ensure_vars(P)
        names = rt.vs.select(None)
        plan = rt._scan_fit_plan(names)
        body = TF.make_scan_free_fit_body(plan, rt.x_ind, 1, 1e-9, 10, rows_traced=bucketed)
        args = rt._bucket_fit_inputs(plan) if bucketed else (rt.x,)
        assert (args[0].shape[0] > 40) == bucketed
        out.append(body(rt.vs.latent_vector(names), *args, stats=new_stats()))
    (zb, nb, ib, n0b), (ze, ne, ie, n0e) = out
    close(nb, ne, rtol=1e-10)
    close(n0b, n0e, rtol=1e-10)
    close(zb, ze, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(ib, ie)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_chain_nll_is_minus_the_score(sparse):
    """The last position's objective is the whole chain, so its NLL is
    minus ``logpdf`` of the training data (under ``compat=False``, which
    normalises it as the fit does); a fixed fit's layer NLLs sum to the
    same."""
    x, y = _data()
    for fix in (False, True):
        rt = TReg(**_kw(sparse), compat=False, device="cpu")
        rt.fit(x, y, fix=fix, iters=2)
        nll = rt.last_fit_report["layer_nll"]
        close(nll[-1] if not fix else np.sum(nll), -rt.logpdf(x, y), rtol=1e-12)


def test_batched_free_fit_raises():
    x, y = _data()
    with pytest.raises(ValueError, match="batched"):
        TReg(**_kw(True), device="cpu").fit(x, y, iters=2, fix=False, fused="batched")
