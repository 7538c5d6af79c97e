"""The ``fit_predict`` entry: each request a fresh estimator fits a fresh
dataset and predicts at every ``rows // test_points``-th row
(``GPARRegressor.fit_predict`` with the configuration's iterations, draws
and credible bounds, the traffic's ``kwargs`` and normals from the
request's seed).

Numbers compared with the reference, each the worst over the requests
checked:

- ``pred_gap``: the widest gap between the program's predictive mean,
  2.5 % or 97.5 % bound and the reference's, over every test input and
  output, in units of that output's training standard deviation;
- ``nll_gap``: the widest gap between a layer's negative log marginal
  likelihood as the fit reports it, at its start and at its end, and the
  reference's at the same hyperparameters and inputs, per data row;
- ``fit_stall``: the likelihood of a layer's data at the hyperparameters its
  fit started from over that at the ones it reached, ``exp(nll - nll0)`` by
  the reference, at its largest over the layers.  A fit that gains reads
  about 0; one whose steps leave the hyperparameters where they were reads 1;
- ``grad_ratio``: the norm of the reference's gradient of a layer's NLL at
  the hyperparameters the fit reached over that at its start, with respect
  to the latents ``log(value - lower)``, at its largest over the layers.  A
  fit that descends along the true gradient shrinks it; one that follows a
  wrong gradient or leaves the state unchanged does not.
"""

import time

import numpy as np

from h100bench.lib import check
from h100bench.lib import traffic as T
from h100bench.lib.data import make_data, smse
from h100bench.lib.work import fit_work, predict_work

#: The faults (``h100bench/lib/faults.py``) a request of this entry can have.
FAULTS = ("stale", "half_rows", "wrong_grad", "half_samples", "altered")
#: The report fields kept with each request.
REPORT = ("layer_nll0", "layer_nll", "layer_iters", "host_syncs", "linesearch_trials",
          "linesearch_episodes", "wall_clock_s", "ladder_escalations", "capture_s")


def setup(run):
    return {}


def call(run, state, req, record):
    """One timed request; its record."""
    cfg = run.cfg
    x, y, x_test = T.fit_inputs(cfg, req)
    nrm = T.normals(cfg, req, len(x_test), run.device, run.dtype)
    reg = run.estimator(x)
    t0 = time.perf_counter()
    out = reg.fit_predict(x, y, x_test, iters=int(cfg["iters"]), num_samples=int(cfg["samples"]),
                          credible_bounds=bool(cfg["credible_bounds"]), normals=nrm,
                          **run.traffic.get("kwargs", {}))
    wall = time.perf_counter() - t0
    rep = reg.last_fit_report
    rec = {"wall_s": wall, "outputs": out, "report": {k: rep[k] for k in REPORT}}
    if record:
        rec["hypers"] = {k: np.asarray(v, float).reshape(-1).tolist()
                         for k, v in reg.get_variables().items()}
    return rec


def end_to_end(records, window_s):
    """``fit_predict_s``: the window's request time over its requests."""
    walls = np.array([r["wall_s"] for r in records])
    return {"fit_predict_s": float(walls.sum() / len(walls))}


def work(run, rec):
    """``(operations, Gram bound ms)`` the request's mathematics needs."""
    sz = run.sizes(rec["size"])
    fit, pred = fit_work(sz, rec["report"]), predict_work(sz, int(run.cfg["test_points"]),
                                                          int(run.cfg["samples"]))
    return fit[0] + pred[0], fit[1] + pred[1]


def judge(run, state, items, candidate=None, log=None):
    """The numbers over ``items``, each a request with its ``outputs``
    (mean, lo, hi), ``hypers`` (the fitted values, name -> list) and
    ``report``.  ``candidate(x, y, x_test, item) -> (outputs, nll0, nll)``
    replaces the program's readings (the control)."""
    cfg, device = run.cfg, run.device
    ref = check.Judge(cfg, device)
    acc = {}
    for it in items:
        x, y, x_test = T.fit_inputs(cfg, it["req"])
        c = ref.condition(x, y, it["hypers"], start=True, grads=True)
        nrm = check.normals(cfg, it["req"], len(x_test), device)
        want = ref.predict(c, x_test, nrm)
        if candidate is None:
            got, nll0, nll = it["outputs"], it["report"]["layer_nll0"], it["report"]["layer_nll"]
        else:
            got, nll0, nll = candidate(x, y, x_test, it)
        n, std = len(x), c["std"].cpu().numpy()
        gap = max(np.max(np.abs(np.asarray(nll, float) - c["nll"])),
                  np.max(np.abs(np.asarray(nll0, float) - c["nll0"]))) / n
        stall = np.exp(np.minimum(np.asarray(c["nll"]) - np.asarray(c["nll0"]), 50.0)).max()
        ratio = np.asarray(c["grad"]) / np.asarray(c["grad0"])
        one = {"pred_gap": check.pred_gap(got, want, std), "nll_gap": float(gap),
               "fit_stall": float(stall), "grad_ratio": float(ratio.max())}
        if log is not None:
            d = np.abs(np.asarray(nll, float) - c["nll"]) / n
            cols = np.max(np.abs(np.asarray(got[0], float) - want[0]) / std, 0)
            f = make_data(n, int(cfg["p"]), it["req"]["data_seed"])[2]
            sm = smse(got[0], f[:: n // len(x_test)][: len(x_test)])
            log(f"[check] request {it['req']['k']} rows {n}: " + ", ".join(
                f"{k} {v:.4g}" for k, v in one.items()) + f"; SMSE against the noiseless truth "
                f"mean {np.mean(sm):.3g}, worst {np.max(sm):.3g}; escalations "
                f"{it['report']['ladder_escalations']}; nll gap by layer "
                f"{np.array2string(d, precision=2)}; gradient ratio by layer "
                f"{np.array2string(ratio, precision=2)}; mean gap by output "
                f"{np.array2string(cols, precision=2)}")
        check.worst(acc, one)
    return acc


def control(run, state):
    """The reference in the precision below the configuration's, at the
    program's hyperparameters, in the program's place."""
    low = check.lower(run.cfg, run.device)

    def candidate(x, y, x_test, it):
        c = low.condition(x, y, it["hypers"], start=True)
        nrm = check.normals(run.cfg, it["req"], len(x_test), run.device)
        return low.predict(c, x_test, nrm), c["nll0"], c["nll"]

    return candidate
