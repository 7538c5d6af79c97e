"""The traced, profiled and non-jitted fit of gpar_torch against the JAX
package's, float64 on the CPU.

- ``params/zoom.py`` (the port's copy of optax's ``lbfgs`` with its zoom
  line search) against ``optax.lbfgs`` through the loop the JAX package's
  ``minimise_l_bfgs_b(trace=True)`` runs (``gpar_tpu/params/optim.py:
  155-166``), 25 iterations: iterates to 1e-10 relative, the same
  line-search step counts, values to 1e-10 relative with an absolute floor
  of 1e-10 (the 2-D Rosenbrock's trajectory grows the last-bit differences
  of XLA's and torch's dot products to about 4e-12 at a value of 0.021).
  Both sides evaluate one NumPy objective (a ``pure_callback`` under
  ``custom_vjp`` in JAX, an ``autograd.Function`` in torch), so the
  optimisers alone are compared.
- ``minimise_l_bfgs_b(trace=True)`` against JAX's on a ``Vars`` objective:
  the printed lines and the returned value; the guard against restarts.
- ``fit(trace=True)`` against JAX's (sparse and dense, and the joint fit),
  ``fit(jit=False)`` against ``fit(fused=False)``, the traced fit under a
  2-shard CPU mesh against one device, and ``fit(profile_dir=)``'s trace.
"""

import contextlib
import glob
import io
import json
import re

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jnp, torch

import optax  # noqa: E402

import gpar_torch  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402
from gpar_tpu.params.optim import minimise_l_bfgs_b as j_minimise  # noqa: E402
from gpar_tpu.params.store import Vars as JVars  # noqa: E402

from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.params import zoom as Z  # noqa: E402
from gpar_torch.params.optim import minimise_l_bfgs_b as t_minimise  # noqa: E402
from gpar_torch.params.store import Vars as TVars  # noqa: E402
from gpar_torch.parallel import make_mesh  # noqa: E402

ITERS_LS = 25
LINE = re.compile(r"lbfgs iter (\d+): objective (\S+)")


# -- the optimiser against optax ---------------------------------------------------


def _rosenbrock(z):
    r = z[1:] - z[:-1] ** 2
    g = np.zeros_like(z)
    g[:-1] += -400.0 * z[:-1] * r - 2.0 * (1.0 - z[:-1])
    g[1:] += 200.0 * r
    return np.sum(100.0 * r**2 + (1.0 - z[:-1]) ** 2), g


_Q = np.linalg.qr(np.random.default_rng(0).standard_normal((8, 8)))[0]
_A = _Q @ np.diag(np.logspace(0, 4, 8)) @ _Q.T  # condition number 1e4


def _quadratic(z):
    return 0.5 * z @ _A @ z + np.sum(z), _A @ z + 1.0


def _box(z):
    """A quartic whose minimiser lies outside the box |z| < 1.5: inf (and a
    NaN gradient) outside."""
    if np.all(np.abs(z) < 1.5):
        return np.sum((z - 3.0) ** 2) + 0.1 * np.sum(z**4), 2.0 * (z - 3.0) + 0.4 * z**3
    return np.inf, np.full_like(z, np.nan)


OBJECTIVES = {
    "rosenbrock2": (_rosenbrock, np.array([-1.2, 1.0])),
    "rosenbrock10": (_rosenbrock, np.linspace(-1.0, 1.0, 10)),
    "quadratic": (_quadratic, np.ones(8)),
    "box": (_box, np.array([-1.0, 0.5, 0.2])),
    # 1e-8 inside the box's corner, the gradient pointing out: every trial
    # of 20 halvings from a unit step leaves the domain, so the search fails
    # with no step of sufficient decrease and optax's ``outside_domain``
    # branch keeps the iterate where it is.
    "box edge": (_box, np.full(3, 1.5 - 1e-8)),
}


def _both(vg_np):
    """One NumPy objective as JAX's value function and torch's: bit-equal
    values and gradients at bit-equal points."""

    def cb(z):
        v, g = vg_np(np.asarray(z, dtype=np.float64))
        return np.float64(v), np.asarray(g, dtype=np.float64)

    scalar = jax.ShapeDtypeStruct((), jnp.float64)

    @jax.custom_vjp
    def fj(z):
        return jax.pure_callback(lambda z: cb(z)[0], scalar, z)

    def fwd(z):
        return jax.pure_callback(cb, (scalar, jax.ShapeDtypeStruct(z.shape, jnp.float64)), z)

    fj.defvjp(fwd, lambda g, ct: (ct * g,))

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z):
            v, g = cb(z.detach().numpy())
            ctx.save_for_backward(torch.as_tensor(g))
            return torch.tensor(v)

        @staticmethod
        def backward(ctx, ct):
            return ct * ctx.saved_tensors[0]

    return fj, Fn.apply


def _optax_run(fun, z0, iters):
    """``gpar_tpu/params/optim.py:155-166``'s loop: per iteration the
    iterate, the state's value and the line search's step count."""
    opt = optax.lbfgs(memory_size=10)
    value_and_grad = optax.value_and_grad_from_state(fun)

    @jax.jit
    def step(z, state):
        value, grad = value_and_grad(z, state=state)
        updates, state = opt.update(grad, state, z, value=value, grad=grad, value_fn=fun)
        return optax.apply_updates(z, updates), state

    z, state, out = z0, opt.init(z0), []
    for _ in range(iters):
        z, state = step(z, state)
        ls = state[-1]
        out.append((np.asarray(z), float(ls.value), int(ls.info.num_linesearch_steps)))
    return out


def _port_run(fun, z0, iters):
    def value_and_grad(z):
        z = z.detach().requires_grad_(True)
        f = fun(z)
        return f.detach(), torch.autograd.grad(f, z)[0]

    z, state, finite, out = z0, Z.lbfgs_init(z0, 10), False, []
    for _ in range(iters):
        value, grad = Z.value_and_grad_from_state(value_and_grad, z, state, finite)
        updates, state = Z.lbfgs_update(grad, state, z, value, value_and_grad)
        z = z + updates
        finite = bool(torch.isfinite(state.value))
        out.append((z.numpy().copy(), float(state.value), state.num_linesearch_steps))
    return out


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_zoom_lbfgs_matches_optax(name):
    vg_np, z0 = OBJECTIVES[name]
    fj, ft = _both(vg_np)
    want = _optax_run(fj, jnp.asarray(z0), ITERS_LS)
    got = _port_run(ft, torch.as_tensor(z0), ITERS_LS)
    assert [s for _, _, s in got] == [s for _, _, s in want]
    zs_got, zs_want = np.stack([z for z, _, _ in got]), np.stack([z for z, _, _ in want])
    assert np.max(np.abs(zs_got - zs_want)) <= 1e-10 * np.max(np.abs(zs_want))
    close([v for _, v, _ in got], [v for _, v, _ in want], rtol=1e-10, atol=1e-10)
    if name == "box edge":
        # Stepsize 0 from the safe step: without the outside_domain branch
        # the line search would return its last (infinite) trial.
        assert all(s == Z.MAX_LINESEARCH_STEPS for _, _, s in got)
        np.testing.assert_array_equal(zs_got[-1], z0)
        assert np.isfinite(got[-1][1])
    else:
        assert got[-1][1] < vg_np(z0)[0]


def test_zoom_helpers_nan_guarded():
    # optax's jnp.where on NaN scalars: a NaN decrease or curvature error
    # counts as infinite (a violated criterion), never as met.
    nan = torch.tensor(float("nan"), dtype=torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64)
    assert torch.isinf(Z._decrease_error(one, nan, nan, one, -one))
    assert torch.isinf(Z._curvature_error(nan, -one))
    # The cubic through a point of infinite value has no minimiser: NaN,
    # which the zoom's validity test rejects.
    inf = torch.tensor(float("inf"), dtype=torch.float64)
    assert torch.isnan(Z._cubicmin(0 * one, one, -one, one, inf, 0.5 * one, one))


# -- minimise_l_bfgs_b(trace=True) ---------------------------------------------------


def _vars_objective(np_):
    def objective(vs):
        a = vs.get(name="a", init=0.5)
        b = vs.bnd(name="b", init=2.0, lower=0.1)
        c = vs.bnd(name="c", init=0.3, lower=0.0, upper=1.0)
        return (a - 3.0) ** 2 + np_.log(b) ** 2 + 10.0 * (b - 1.5 * c) ** 2 + (a * c - 0.2) ** 2

    return objective


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _objectives(text):
    return [(int(i), float(v)) for i, v in LINE.findall(text)]


def test_minimise_trace_matches_jax():
    fj, tj = _printed(lambda: j_minimise(_vars_objective(jnp), JVars(), iters=15, trace=True))
    vt = TVars(dtype=torch.float64, device="cpu")
    stats = {"host_syncs": 0, "linesearch_episodes": 0, "linesearch_trials": 0}
    (f0, ft, it), tt = _printed(lambda: t_minimise(_vars_objective(torch), vt, iters=15, trace=True,
                                                   stats=stats))
    want, got = _objectives(tj), _objectives(tt)
    assert len(want) > 3 and [i for i, _ in got] == [i for i, _ in want] == list(range(1, it + 1))
    close([v for _, v in got], [v for _, v in want], rtol=0, atol=1e-6)
    close(ft, fj, rtol=1e-10)
    assert f0 > ft
    # One read per iteration and per line-search step; one evaluation per step.
    assert stats["host_syncs"] == it + stats["linesearch_trials"]
    assert stats["evaluations"] == 1 + stats["linesearch_trials"]


def test_minimise_trace_rejects_restarts():
    calls = []

    def objective(vs):
        calls.append(1)
        return (vs.get(name="z", init=1.0) - 3.0) ** 2

    with pytest.raises(ValueError, match="restarts"):
        t_minimise(objective, TVars(dtype=torch.float64, device="cpu"), trace=True, restarts=4)
    assert not calls  # raised before any evaluation
    x, y, _ = chain_data(n=12, p=2, seed=1)
    with pytest.raises(ValueError, match="restarts"):
        TReg(**bench_kwargs(n_ind=4), device="cpu").fit(x, y, iters=2, trace=True, restarts=2)


# -- fit(trace=True) against JAX's --------------------------------------------------

FIT_CASES = [("sparse", True), ("dense", True), ("sparse", False)]


def _data():
    return chain_data(n=24, p=2, seed=0)[:2]


def _kw(model):
    kw = bench_kwargs(n_ind=6)
    if model == "dense":
        kw["x_ind"] = None
    return kw


@pytest.fixture(scope="module", params=FIT_CASES, ids=lambda c: f"{c[0]}-fix{c[1]}")
def traced_fits(request):
    from gpar_tpu.utils.checkpoint import state_dict

    from gpar_torch.utils.checkpoint import load_state_dict

    model, fix = request.param
    x, y = _data()
    rj = JReg(**_kw(model))
    rj.condition(x, y)
    rj._ensure_vars(rj.p)
    # The JAX estimator's initial parameters carried across.
    rt = load_state_dict(state_dict(rj), device="cpu")
    _, out_j = _printed(lambda: rj.fit(x, y, iters=5, fix=fix, trace=True))
    _, out_t = _printed(lambda: rt.fit(x, y, iters=5, fix=fix, trace=True))
    return dict(rj=rj, rt=rt, out_j=out_j, out_t=out_t, fix=fix)


def test_traced_fit_matches_jax(traced_fits):
    rj, rt = traced_fits["rj"], traced_fits["rt"]
    rep = rt.last_fit_report
    assert rep["fused"] is False and rep["trace"] and not rep["cuda_graphs"]
    close(rep["layer_nll"], rj.last_fit_report["layer_nll"], rtol=1e-8)
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    assert list(sj) == list(st)
    for k in sj:
        close(st[k], sj[k], rtol=1e-7, atol=1e-7)
    want, got = _objectives(traced_fits["out_j"]), _objectives(traced_fits["out_t"])
    assert len(got) == len(want) == 2 * 5
    assert [i for i, _ in got] == [i for i, _ in want]
    close([v for _, v in got], [v for _, v in want], rtol=0, atol=1e-6)
    start = "Training conditionals: 0/2\rTraining conditionals: 1/2  lbfgs iter 1:"
    assert traced_fits["out_j"].startswith(start) and traced_fits["out_t"].startswith(start)
    # The report: what the JAX package returns, and the optimiser's counts.
    np.testing.assert_array_equal(rep["layer_iters"], [5, 5])
    assert np.all(rep["layer_nll"] < rep["layer_nll0"])
    assert rep["evaluations"] == 2 + rep["linesearch_trials"]
    assert rep["host_syncs"] == 10 + rep["linesearch_trials"]


def test_traced_fit_predict_passes_trace(capsys):
    x, y = _data()
    r = TReg(**_kw("sparse"), device="cpu")
    mean = r.fit_predict(x, y, num_samples=3, iters=2, trace=True)
    assert r.last_fit_report["trace"] and r.last_fit_report["fused"] is False
    assert len(_objectives(capsys.readouterr().out)) == 4
    assert np.isfinite(mean).all()


@pytest.mark.parametrize("fix", [True, False])
def test_jit_false_is_the_per_layer_driver(fix, capsys):
    x, y = _data()
    runs = []
    for kw in (dict(jit=False), dict(fused=False), dict(jit=False, fused="batched")):
        r = TReg(**_kw("dense"), device="cpu")
        r.fit(x, y, iters=4, fix=fix, **kw)
        runs.append((r.last_fit_report, r.vs.snapshot(), capsys.readouterr().out))
    (a, za, oa), (b, zb, ob), (c, zc, _) = runs
    assert a["fused"] is False and not a["trace"] and oa == ob
    assert "Training conditionals: 2/2" in oa and "lbfgs iter" not in oa
    for rep, z in ((b, zb), (c, zc)):
        np.testing.assert_array_equal(a["layer_nll"], rep["layer_nll"])
        for k in za:
            np.testing.assert_array_equal(za[k], z[k])


def test_traced_fit_under_mesh():
    x, y = chain_data(n=32, p=2, seed=2)[:2]
    runs = []
    for mesh in (None, make_mesh(2, devices=[torch.device("cpu")] * 2)):
        r = TReg(**_kw("sparse"), device="cpu")
        ctx = gpar_torch.use_mesh(mesh, min_rows=8) if mesh else contextlib.nullcontext()
        with ctx:
            _printed(lambda: r.fit(x, y, iters=5, trace=True))
        runs.append(r)
    single, meshed = runs
    close(meshed.last_fit_report["layer_nll"], single.last_fit_report["layer_nll"], rtol=1e-8)
    s1, s2 = single.vs.snapshot(), meshed.vs.snapshot()
    for k in s1:
        close(s2[k], s1[k], rtol=1e-7, atol=1e-8)


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    x, y = _data()
    r = TReg(**_kw("sparse"), device="cpu")
    r.fit(x, y, iters=2, profile_dir=str(tmp_path))
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # The fit's own operations: the Gram's autograd function and the
    # factorisation, forward and backward.
    assert {"_GramFn", "aten::linalg_cholesky_ex", "LinalgCholeskyExBackward0"} <= names
    assert r.last_fit_report["fused"] is True and r.last_fit_report["cuda_graphs"] is False
    # The traced fit under the profiler: a second trace, the lines printed.
    r.fit(x, y, iters=2, trace=True, profile_dir=str(tmp_path))
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 2
    assert len(_objectives(capsys.readouterr().out)) == 4
