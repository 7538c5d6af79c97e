"""gpar_torch.params (store, L-BFGS, optimiser) against gpar_tpu.

The L-BFGS port follows the JAX package's trajectory decision for
decision, so on the same float64 objective and start the iterates agree
to 1e-8 after 10 iterations and the iteration counts are equal.
"""

import numpy as np
import pytest

from .test_torch_common import close, jax, jnp, np_, torch

from gpar_tpu.params.lbfgs import lbfgs_minimize as j_lbfgs  # noqa: E402
from gpar_tpu.params.optim import minimise_l_bfgs_b as j_minimise  # noqa: E402
from gpar_tpu.params.store import Vars as JVars  # noqa: E402

from gpar_torch.params.lbfgs import lbfgs_minimize as t_lbfgs  # noqa: E402
from gpar_torch.params.optim import minimise_l_bfgs_b as t_minimise  # noqa: E402
from gpar_torch.params.store import Vars as TVars  # noqa: E402
from gpar_torch.params.store import load_latents  # noqa: E402


def _rosenbrock(lib):
    def f(z):
        return lib.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2 + (1.0 - z[:-1]) ** 2)

    return f


@pytest.mark.parametrize("iters", [3, 10])
def test_lbfgs_matches_jax_on_rosenbrock(iters):
    z0 = np.random.default_rng(0).uniform(-1.5, 1.5, 6)
    zj, fj, itj, f0j = j_lbfgs(_rosenbrock(jnp), jnp.asarray(z0), iters=iters)
    zt, ft, itt, f0t = t_lbfgs(_rosenbrock(torch), torch.as_tensor(z0), iters=iters)
    assert int(itj) == itt == iters
    close(f0t, f0j, rtol=1e-12)
    close(zt, zj, rtol=1e-8)
    close(ft, fj, rtol=1e-8)


def test_lbfgs_converges_and_stops_like_jax():
    # A convex quadratic: both stop on the same convergence test at the
    # same iteration, long before the budget.
    A = np.diag(np.linspace(1.0, 5.0, 4))
    b = np.arange(4.0)

    def quad(lib, Am, bm):
        return lambda z: 0.5 * lib.sum(z * (Am @ z)) - lib.sum(bm * z)

    zj, fj, itj, _ = j_lbfgs(quad(jnp, jnp.asarray(A), jnp.asarray(b)), jnp.zeros(4), iters=200)
    zt, ft, itt, _ = t_lbfgs(quad(torch, torch.as_tensor(A), torch.as_tensor(b)),
                             torch.zeros(4, dtype=torch.float64), iters=200)
    assert itt == int(itj) < 200
    close(zt, zj, rtol=1e-8, atol=1e-12)
    close(zt, np.linalg.solve(A, b), rtol=1e-6)


def test_lbfgs_backtracks_non_finite_values_like_jax():
    # The objective is NaN beyond z = 1.5 (log of a negative number): trial
    # points there shrink the step like a failed Armijo test.
    def barrier(lib):
        return lambda z: lib.sum((z - 3.0) ** 2) - lib.sum(lib.log(1.5 - z))

    z0 = np.array([0.0, 0.5, -1.0])
    zj, fj, itj, _ = j_lbfgs(barrier(jnp), jnp.asarray(z0), iters=10)
    zt, ft, itt, _ = t_lbfgs(barrier(torch), torch.as_tensor(z0), iters=10)
    assert itt == int(itj) and np.isfinite(np_(ft))
    close(zt, zj, rtol=1e-8)
    close(ft, fj, rtol=1e-8)


def _stores():
    jv, tv = JVars(), TVars(device="cpu")
    for vs in (jv, tv):
        vs.bnd(name="0/var", init=1.3)
        vs.bnd(name="0/scales", init=np.array([0.5, 2.0]))
        vs.bnd(name="0/noise", init=0.1, lower=1e-8)
        vs.bnd(name="1/alpha", init=1e-2, lower=1e-3, upper=1e3)
        vs.get(name="1/const", init=-0.7)
    return jv, tv


def test_store_latents_transforms_and_selection_match_jax():
    jv, tv = _stores()
    assert jv.names == tv.names
    js, ts = jv.snapshot(), tv.snapshot()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])  # identical NumPy unconstrain
        close(tv[k], jv[k], rtol=1e-15)
    for pat in (None, "0/*", ["1/*", "0/var"], "*/noise"):
        assert tv.select(pat) == jv.select(pat)
    names = tv.select("0/*")
    close(tv.latent_vector(names), jv.latent_vector(names), rtol=0)
    z = torch.arange(4, dtype=torch.float64)
    view = tv.with_latent_vector(names, z)
    close(view["0/scales"], np.exp([1.0, 2.0]), rtol=1e-15)
    close(view["1/const"], -0.7, rtol=0)


def test_snapshot_restore_and_load_latents():
    jv, tv = _stores()
    snap = tv.snapshot()
    tv.set_latent_vector(tv.names, torch.zeros(6, dtype=torch.float64))
    tv.restore(snap)
    for k, v in snap.items():
        np.testing.assert_array_equal(np_(tv._latents[k]), v)
    # A JAX snapshot loads into the port store.
    r = np.random.default_rng(1)
    jv.restore({k: v + r.standard_normal(np.shape(v)) for k, v in jv.snapshot().items()})
    load_latents(tv, jv.snapshot())
    for k in jv.names:
        close(tv[k], jv[k], rtol=1e-15)
    with pytest.raises(KeyError, match="unknown"):
        load_latents(tv, {"9/nope": np.zeros(())})
    with pytest.raises(ValueError, match="shape"):
        load_latents(tv, {"0/scales": np.zeros(3)})


def test_minimise_l_bfgs_b_matches_jax():
    jv, tv = _stores()
    target = {"0/var": 2.0, "0/scales": np.array([1.0, 3.0]), "0/noise": 0.05}

    def objective(lib):
        asarray = jnp.asarray if lib is jnp else torch.as_tensor

        def obj(vs):
            dist = sum(lib.sum((vs[k] - asarray(v)) ** 2) for k, v in target.items())
            return dist + vs["1/const"] ** 2

        return obj

    fj = j_minimise(objective(jnp), jv, names=["0/*"], iters=8)
    f0t, ft, itt = t_minimise(objective(torch), tv, names=["0/*"], iters=8)
    close(ft, fj, rtol=1e-8)
    assert itt <= 8 and f0t > ft
    for k in jv.names:
        close(tv.snapshot()[k], jv.snapshot()[k], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("init, bounds", [(-1.0, dict()), (0.5, dict(lower=1.0)),
                                          (5.0, dict(lower=1.0, upper=3.0))])
def test_init_outside_its_bounds_is_nan_without_a_warning(init, bounds):
    # The NumPy unconstrain of a bounded transform: the log of a negative
    # number is NaN, silently, as on the JAX package's jnp path.
    import warnings

    tv = TVars(dtype=torch.float64, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        tv.bnd(init=init, name="v", **bounds)
    assert np.isnan(tv.snapshot()["v"]).all()
