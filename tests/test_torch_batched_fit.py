"""``fit(fused="batched")`` of gpar_torch — every layer's L-BFGS as one batch
(``models/fused.py``'s ``make_batched_fit_body``) — against gpar_tpu's
batched body and against the port's own scan fit, float64, on the CPU.

Fully observed data (24 rows, p=3), the dense model with ``replace=False``
in two configurations (the JAX package's own batched-fit test's,
``tests/test_fused_scan.py:674-704``).  Tolerances:

- against JAX's ``fit(fused="batched", restarts=R, key=...)`` with JAX's
  normals (``test_torch_common.jax_restart_normals``), R = 1 in one
  configuration and 2 in the other: layer NLLs and latents 1e-8, layer
  iterations equal;
- against the port's scan fit with the same normals (the two routes draw
  the same (R - 1, s_max) stream): at ``iters=0`` the layer NLLs to 1e-10;
  at 6 iterations with 2 starts the layer NLLs and the latents to 1e-8
  (JAX's own test holds its two bodies to 1e-6 and 1e-4);
- every broken precondition raises JAX's ``ValueError``, message for
  message.
"""

import numpy as np
import pytest

from .test_torch_common import chain_data, close, jax, jax_restart_normals

import gpar_tpu.models.fused as JF  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402

P, N, ITERS = 3, 24, 4

CONFIGS = {
    "eq": dict(noise=0.1, normalise_y=True),
    "rq-markov": dict(noise=0.1, markov=1, rq=True, nonlinear=True, normalise_y=False),
}


def _data():
    x, y, _ = chain_data(n=N, p=P, seed=2)
    return x, y  # fully observed


def _port(kw, x, y):
    rt = TReg(**kw, device="cpu")
    rt.condition(x, y)
    rt._ensure_vars(P)
    return rt


def _normals(rt, restarts, key):
    if restarts == 1:
        return None
    s_max = rt._scan_fit_plan(rt.vs.select(None)).s_max
    return jax_restart_normals(key, "batched", P, restarts, s_max)


@pytest.mark.parametrize("config, restarts", [("eq", 1), ("rq-markov", 2)])
def test_batched_fit_matches_jax(config, restarts):
    x, y = _data()
    kw, key = CONFIGS[config], jax.random.PRNGKey(7)
    rj = JReg(**kw)
    rj.fit(x, y, iters=ITERS, fused="batched", restarts=restarts, key=key)
    rt = _port(kw, x, y)
    rt.fit(x, y, iters=ITERS, fused="batched", restarts=restarts,
           restart_normals=_normals(rt, restarts, key))
    rep, jrep = rt.last_fit_report, rj.last_fit_report
    assert rep["fused"] is True and rep["restarts"] == restarts and rep["graph_replays"] == 0
    close(rep["layer_nll"], jrep["layer_nll"], rtol=1e-8)
    close(rep["layer_nll0"], jrep["layer_nll0"], rtol=1e-10)
    np.testing.assert_array_equal(rep["layer_iters"], np.asarray(jrep["layer_iters"]))
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    for k in sj:
        close(st[k], sj[k], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_batched_fit_matches_the_scan_fit(config):
    # With fully observed dense data, replace=False and no scale_tie the
    # layers are independent: the batched fit is the scan fit.
    x, y = _data()
    kw = CONFIGS[config]
    key = jax.random.PRNGKey(1)
    for iters, restarts, tol in ((0, 1, 1e-10), (6, 2, 1e-8)):
        fits = []
        for fused in (True, "batched"):
            rt = _port(kw, x, y)
            rt.fit(x, y, iters=iters, fused=fused, restarts=restarts,
                   restart_normals=_normals(rt, restarts, key))
            fits.append(rt)
        scan, bat = fits
        close(bat.last_fit_report["layer_nll"], scan.last_fit_report["layer_nll"], rtol=tol)
        np.testing.assert_array_equal(bat.last_fit_report["layer_iters"],
                                      scan.last_fit_report["layer_iters"])
        ss, sb = scan.vs.snapshot(), bat.vs.snapshot()
        for k in ss:
            close(sb[k], ss[k], rtol=tol, atol=tol)


@pytest.mark.parametrize("broken", ["dense", "replace", "scale_tie", "fully-observed"])
def test_batched_fit_rejects_dependent_layers_as_jax_does(broken):
    x, y = _data()
    kw = dict(noise=0.1)
    if broken == "dense":
        kw["x_ind"] = np.linspace(0, 10, 5)
    elif broken == "replace":
        kw["replace"] = True
    elif broken == "scale_tie":
        kw["scale_tie"] = True
    else:
        y = y.copy()
        y[3, 1] = np.nan
    msgs = []
    for R, mod in ((JReg, JF), (TReg, TF)):
        reg = R(**kw) if R is JReg else R(**kw, device="cpu")
        reg.condition(x, y)
        reg._ensure_vars(reg.p)
        plan = mod.build_scan_fit_plan(reg, reg.vs.select(None))
        with pytest.raises(ValueError, match=broken.replace("-", "")[:5]) as err:
            mod.make_batched_fit_body(plan, 5, 1e-9, 10, 1, 1.0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    # The estimator raises it too.
    rt = TReg(**kw, device="cpu")
    with pytest.raises(ValueError, match=msgs[1]):
        rt.fit(x, y, iters=1, fused="batched")
