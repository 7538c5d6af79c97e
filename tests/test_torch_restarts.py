"""Multi-start fits, ``fit(restarts=R)``, of gpar_torch against gpar_tpu's,
float64, on the CPU, and the batched pieces under them: the batched
L-BFGS, the layer objective over a batch of latents (the Gram with
per-element hyperparameters, its VJP, the per-element jitter ladder) and
the scan step's bodies with restarts.

The benchmark's configuration scaled down (p=2, 24 rows, NaNs in the later
output, ``impute`` on; sparse with 6 inducing points and dense), 3 starts
per layer.  The restart perturbations are JAX's own normals
(``test_torch_common.jax_restart_normals``, the key stream of each route).
Tolerances:

- the plain batched Gram and its VJP, per-element trees (the gated bench
  tree and an RQ tree), against ``jax.vmap`` of the JAX package's ``gram``
  and ``jax.vjp``: 1e-12;
- the layer NLL and its gradient over a batch of latents against the
  per-element (unbatched) objective: 1e-12; against ``jax.vmap`` of the
  JAX layer objective and ``jax.grad``: 1e-10;
- the batched L-BFGS: each element against ``lbfgs_minimize`` run alone,
  1e-12 (same iterations), and against ``jax.vmap`` of JAX's
  ``lbfgs_minimize``, 1e-10; the multi-start driver against JAX's
  ``lbfgs_traced_restarts`` with the same normals, 1e-10;
- the whole fit, on each route (the graph-free scan step, the joint fit,
  the per-layer driver), sparse and dense: latents and layer NLLs against
  ``gpar_tpu``'s ``fit(restarts=3, key=...)``, 1e-8; layer iterations
  equal.
"""

import numpy as np
import pytest

from .test_torch_common import (
    bench_kwargs, chain_data, close, jax, jax_restart_normals, jnp, np_, torch,
)

import gpar_tpu.models.fused as JF  # noqa: E402
import gpar_tpu.ops.kernels as JK  # noqa: E402
import gpar_tpu.ops.linalg as JL  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402
from gpar_tpu.params.lbfgs import lbfgs_minimize as j_lbfgs  # noqa: E402
from gpar_tpu.params.optim import lbfgs_traced_restarts  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
import gpar_torch.ops.kernels as TK  # noqa: E402
import gpar_torch.ops.linalg as TL  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.params.lbfgs import (  # noqa: E402
    lbfgs_minimize, lbfgs_minimize_batched, lbfgs_minimize_restarts, new_stats,
)

P, N, ITERS, R = 2, 24, 3, 3
KEY = 3

ROUTES = {
    "scan": dict(fused=True, fix=True),
    "joint": dict(fused=True, fix=False),
    "layer": dict(fused=False, fix=True),
}


def _data():
    x, y, _ = chain_data(n=N, p=P, seed=0)
    r = np.random.default_rng(4)
    y[:, 1:][r.uniform(size=(N, P - 1)) < 0.12] = np.nan
    return x, y


def _kw(sparse, **kw):
    out = dict(bench_kwargs(n_ind=6), **kw)
    if not sparse:
        out["x_ind"] = None
    return out


def _conditioned(kw, x, y):
    rt = TReg(**kw, device="cpu")
    rt.condition(x, y)
    rt._ensure_vars(rt.p)
    return rt


def _route_normals(rt, route, key):
    """JAX's restart normals for ``route``, in the port's form."""
    if route == "layer":
        width = [int(rt.vs.latent_vector(rt.vs.select([f"{pi}/*"])).shape[0]) for pi in range(P)]
    else:
        plan = rt._scan_fit_plan(rt.vs.select(None))
        width = plan.s_max if route == "scan" else plan.n_z
    return jax_restart_normals(key, route, P, R, width)


# -- the whole fit ---------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_restarts_match_jax(route, sparse):
    x, y = _data()
    kw, key = _kw(sparse), jax.random.PRNGKey(KEY)
    rj = JReg(**kw)
    rj.fit(x, y, iters=ITERS, restarts=R, key=key, **ROUTES[route])
    rt = _conditioned(kw, x, y)
    rt.fit(x, y, iters=ITERS, restarts=R, restart_normals=_route_normals(rt, route, key),
           **ROUTES[route])
    rep, jrep = rt.last_fit_report, rj.last_fit_report
    assert rep["restarts"] == R
    close(rep["layer_nll"], jrep["layer_nll"], rtol=1e-8)
    if route != "layer":  # JAX's per-layer driver reports no iterations
        np.testing.assert_array_equal(rep["layer_iters"], np.asarray(jrep["layer_iters"]))
        close(rep["layer_nll0"], jrep["layer_nll0"], rtol=1e-10)
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    for k in sj:
        close(st[k], sj[k], rtol=1e-8, atol=1e-10)


def test_restarts_never_lose_to_a_single_start_and_draw_from_the_generator():
    x, y = _data()
    kw = _kw(True)
    one = TReg(**kw, device="cpu")
    one.fit(x, y, iters=ITERS)
    assert one.last_fit_report["restarts"] == 1
    runs = []
    for _ in range(2):
        rt = TReg(**kw, device="cpu")
        rt.fit(x, y, iters=ITERS, restarts=R, restart_scale=0.5,
               generator=torch.Generator().manual_seed(11))
        runs.append(rt)
    # Layer 0's element 0 is the single start, so its best can only match
    # or beat it (later layers see other inputs once layer 0 moved).
    assert runs[0].last_fit_report["layer_nll"][0] <= one.last_fit_report["layer_nll"][0] + 1e-9
    close(runs[0].last_fit_report["layer_nll0"][0], one.last_fit_report["layer_nll0"][0],
          rtol=1e-12)
    np.testing.assert_array_equal(runs[0].last_fit_report["layer_nll"],
                                  runs[1].last_fit_report["layer_nll"])
    rt = TReg(**kw, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        rt.fit(x, y, iters=1, restarts=R, restart_normals=[np.zeros((R, 3))] * P)


# -- the batched L-BFGS ------------------------------------------------------------------


_RNG = np.random.default_rng(0)
_Q = np.linalg.qr(_RNG.normal(size=(3, 3)))[0]
_A = _Q @ np.diag([1.0, 2.0, 4.0]) @ _Q.T
_B = _RNG.normal(size=3)


def _objective(kind, lib=torch):
    """A convex quadratic plus a quartic (its steep walls make far starts
    backtrack), or plus a log barrier at 1.5 (a start outside it is
    non-finite: every trial fails, the element stops and keeps its start),
    per row of ``z`` (..., 3)."""
    A, B = (torch.as_tensor(_A), torch.as_tensor(_B)) if lib is torch else (_A, _B)

    def fun(z):
        quad = 0.5 * lib.sum((z @ A) * z, axis=-1) - z @ B
        if kind == "quartic":
            return quad + 0.25 * lib.sum(z**4, axis=-1)
        return quad - lib.sum(lib.log(1.5 - z), axis=-1)

    return fun


# Starts that converge after different numbers of iterations; one of them
# backtracks (quartic) or leaves the barrier's domain (barrier).
_STARTS = np.array([[-0.3, 0.2, 0.1], [4.0, -3.0, 2.0], [1.4, 1.3, -2.0], [0.5, 0.4, 0.9]])


@pytest.mark.parametrize("kind", ["quartic", "barrier"])
def test_batched_lbfgs_elements_follow_their_solo_trajectories(kind):
    fun = _objective(kind)
    starts = torch.as_tensor(_STARTS)
    stats = new_stats()
    zs, fs, its, f0s = lbfgs_minimize_batched(fun, starts, iters=40, stats=stats)
    assert stats["linesearch_trials"] > 0 and len(set(its.tolist())) > 1
    for b in range(len(_STARTS)):
        z, f, it, f0 = lbfgs_minimize(lambda v: fun(v[None])[0], starts[b], iters=40)
        close(zs[b], z, rtol=1e-12, atol=1e-14)
        close(fs[b], f, rtol=1e-12, atol=1e-14)
        close(f0s[b], f0, rtol=1e-12)
        assert int(its[b]) == it
    jz, jf, jit, jf0 = jax.vmap(lambda v: j_lbfgs(_objective(kind, jnp), v, iters=40))(
        jnp.asarray(_STARTS))
    close(zs, jz, rtol=1e-10, atol=1e-12)
    close(fs, jf, rtol=1e-10, atol=1e-12)
    close(f0s, jf0, rtol=1e-12)
    np.testing.assert_array_equal(np_(its), np.asarray(jit))


def test_restart_driver_matches_jax_traced_restarts():
    key, z0 = jax.random.PRNGKey(5), _STARTS[1]
    normals = np.array(jax.random.normal(key, (3, 3), dtype=jnp.float64))
    # Four iterations: the starts end apart, so the best is not a tie of
    # converged values decided by rounding.
    got = lbfgs_minimize_restarts(_objective("quartic"), torch.as_tensor(z0),
                                  torch.as_tensor(normals), restart_scale=0.5, iters=4)
    want = lbfgs_traced_restarts(_objective("quartic", jnp), jnp.asarray(z0), key, 4,
                                 restart_scale=0.5, iters=4)
    for a, b in zip(got, want):
        close(a, b, rtol=1e-10, atol=1e-12)


# -- the layer objective over a batch of latents -----------------------------------------


def _plan_pair(sparse, **kw):
    x, y = _data()
    kw = _kw(sparse, **kw)
    rj, rt = JReg(**kw), _conditioned(kw, x, y)
    rj.condition(x, y)
    rj._ensure_vars(P)
    names = rt.vs.select(None)
    return rj, rt, JF.build_scan_fit_plan(rj, names), TF.build_scan_fit_plan(rt, names), names


def _latent_batch(rt, names, plan, B=3):
    z = np.r_[np_(rt.vs.latent_vector(names)), 0.0]
    r = np.random.default_rng(8)
    return z[None] + 0.4 * r.standard_normal((B, plan.n_z + 1)) * (np.arange(plan.n_z + 1) < plan.n_z)


@pytest.mark.parametrize("rq", [False, True], ids=["gated-bench", "rq"])
def test_batched_gram_and_vjp_match_jax_vmap(rq):
    _, _, pj, pt, names = _plan_pair(True, rq=rq)
    rt = _conditioned(_kw(True, rq=rq), *_data())
    Z = _latent_batch(rt, names, pt)
    pi = 1
    lin_t = {k: v[pi] for k, v in TF.plan_tensors(pt, torch.float64, "cpu").items()}
    lin_j = {k: jnp.asarray(v[pi]) for k, v in pj.xs.items()}
    r = np.random.default_rng(2)
    xa, ya = r.normal(size=(7, pt.W)), r.normal(size=(5, pt.W))
    G = r.normal(size=(len(Z), 7, 5))

    Zt = torch.as_tensor(Z).requires_grad_(True)
    xt = torch.as_tensor(xa).requires_grad_(True)
    kernel, _ = TF._layer_kernel(pt, lin_t, Zt)
    Kt = TK.gram(kernel, xt, torch.as_tensor(ya))
    gZ, gx = torch.autograd.grad(torch.sum(Kt * torch.as_tensor(G)), (Zt, xt))

    def one(z, a):
        return JK.gram(JF._layer_kernel(pj, lin_j, z)[0], a, jnp.asarray(ya))

    Kj, vjp = jax.vjp(jax.jit(lambda Zs, a: jax.vmap(one, in_axes=(0, None))(Zs, a)), jnp.asarray(Z),
                      jnp.asarray(xa))
    jZ, jx = vjp(jnp.asarray(G))
    assert tuple(Kt.shape) == (len(Z), 7, 5)
    close(Kt, Kj, rtol=1e-12, atol=1e-12)
    close(gZ, jZ, rtol=1e-12, atol=1e-12)
    close(gx, jx, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_batched_layer_objective_matches_per_element_and_jax(sparse):
    rj, rt, pj, pt, names = _plan_pair(sparse)
    Z = _latent_batch(rt, names, pt)
    pi = 1
    xs_t = TF.plan_tensors(pt, torch.float64, "cpu")
    lin_t = {k: v[pi] for k, v in xs_t.items()}
    lin_j = {k: jnp.asarray(v[pi]) for k, v in pj.xs.items()}
    r = np.random.default_rng(7)
    x_aug = np.concatenate([np.asarray(rt._x_np), r.normal(size=(N, P))], axis=1)
    zi_aug = (np.concatenate([np.linspace(0, 10, 6)[:, None], r.normal(size=(6, P))], axis=1)
              if sparse else np.zeros((0, pt.W)))
    xa, za = torch.as_tensor(x_aug), torch.as_tensor(zi_aug)
    ladder = TL.Jitter("device")

    def nll(z):
        return TF._layer_nll_factors(pt, lin_t, z, xa, za, ladder)[0]

    Zt = torch.as_tensor(Z).requires_grad_(True)
    f = nll(Zt)
    (g,) = torch.autograd.grad(f.sum(), Zt)
    for b in range(len(Z)):
        zb = torch.as_tensor(Z[b]).requires_grad_(True)
        fb = nll(zb)
        (gb,) = torch.autograd.grad(fb, zb)
        close(f[b], fb, rtol=1e-12)
        close(g[b], gb, rtol=1e-12, atol=1e-12 * float(torch.max(torch.abs(gb))))
    eps = JL.resolve_epsilon(jnp.float64)

    def jnll(z):
        return JF._layer_nll_factors(pj, lin_j, z, jnp.asarray(x_aug), jnp.asarray(zi_aug), eps)[0]

    fj, gj = jax.jit(jax.vmap(jax.value_and_grad(jnll)))(jnp.asarray(Z))
    close(f, fj, rtol=1e-10)
    close(g, gj, rtol=1e-10, atol=1e-10 * float(np.max(np.abs(np.asarray(gj)))))


def test_on_device_ladder_picks_its_rung_per_element():
    # Element 0 holds at the first rung; element 1 only at the second
    # (1e-9): one escalation, and each element factored as if alone.
    K = torch.as_tensor(np.stack([
        np.array([[2.0, 0.3], [0.3, 1.0]]),
        np.array([[1.0, 0.3], [0.3, 0.09 - 1e-10]]),
    ]))
    ladder = TL.Jitter("device")
    L = ladder.cholesky(K)
    assert int(ladder.count) == 1
    for b in range(2):
        one = TL.Jitter("device")
        close(L[b], one.cholesky(K[b]), rtol=1e-15, atol=1e-15)
        close(L[b], JL.safe_cholesky(jnp.asarray(K[b].numpy())), rtol=0, atol=1e-12)
        assert int(one.count) == b


def test_step_bodies_with_restarts_read_nothing_back_to_the_host():
    _, rt, _, pt, _ = _plan_pair(True)
    step = TF.ScanStep(pt, 64, 6, torch.float64, "meta", restarts=R)
    assert tuple(step.opt.state.z.shape) == (R, pt.s_max)
    run = TF.Eager(step)
    for name in step.BODIES:
        run(name)


def test_graph_cache_keys_on_restarts():
    import gpar_torch.models.graphs as TGr

    _, _, _, pt, _ = _plan_pair(True)
    keys = [TGr._key(pt, 64, 6, torch.float64, "cpu", 3, 1e-9, 10, r) for r in (1, 2)]
    assert keys[0] != keys[1]
    assert keys[0] == TGr._key(pt, 64, 6, torch.float64, "cpu", 3, 1e-9, 10)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_scan_restarts_equal_the_per_layer_driver_with_the_same_normals(sparse):
    # A layer's padded span lists its latents in the per-layer driver's
    # order, so the scan's normals cut to each layer's width start the
    # driver from the same points: the two routes agree (as at one start,
    # tests/test_torch_fused.py).  chip_smoke.py's [small] phase holds the
    # two on the card the same way.
    x, y = _data()
    kw = _kw(sparse)
    rt = _conditioned(kw, x, y)
    plan = rt._scan_fit_plan(rt.vs.select(None))
    widths = [int(rt.vs.latent_vector(rt.vs.select([f"{pi}/*"])).shape[0]) for pi in range(P)]
    normals = np.random.default_rng(6).standard_normal((P, R - 1, plan.s_max))
    fits = []
    for fused, nrm in ((True, list(normals)), (False, [a[:, :w] for a, w in zip(normals, widths)])):
        reg = TReg(**kw, device="cpu")
        reg.fit(x, y, iters=ITERS, restarts=R, fused=fused, restart_normals=nrm)
        fits.append(reg)
    close(fits[0].last_fit_report["layer_nll"], fits[1].last_fit_report["layer_nll"], rtol=1e-8)
    np.testing.assert_array_equal(fits[0].last_fit_report["layer_iters"],
                                  fits[1].last_fit_report["layer_iters"])
    sa, sb = fits[0].vs.snapshot(), fits[1].vs.snapshot()
    for k in sa:
        close(sa[k], sb[k], rtol=1e-8, atol=1e-10)
