"""The ``predict_ancestral`` entry: the ``predict`` entry (``entries/
predict.py``) on outputs with gaps, for a ``replace=False`` configuration.
Set-up fits one dataset of the configuration's ``serve_rows`` whose outputs
listed under ``gaps`` are missing (NaN) over their stretch of the x range
and calls ``precompute()``; each request is ``GPARRegressor.predict`` on
fresh test inputs, every draw its own ancestral chain.

The number compared with the reference (``reference/gpar_ancestral.py``),
the worst over the requests checked: ``pred_gap``, the widest gap between
the program's predictive mean, 2.5 % or 97.5 % bound and the reference's,
over every test input and output, in units of that output's training
standard deviation (over its observed values).  The reference conditions
each layer on its observed rows, with the gaps of earlier outputs filled
by their posterior means, at the hyperparameters the set-up's fit reached,
and runs each draw's chain from the program's normals.
"""

import numpy as np

from h100bench.entries import predict
from h100bench.lib import check
from h100bench.lib import traffic as T
from h100bench.lib.work_ancestral import predict_work

FAULTS = ("half_samples", "altered")
end_to_end = predict.end_to_end


def with_gaps(cfg, x, y):
    """``y`` with each output of ``cfg["gaps"]`` (column -> [lo, hi), as
    fractions of the x range) missing over its stretch; outputs past the
    configuration's ``p`` are left out."""
    y = np.array(y, copy=True)
    frac = (x - x.min()) / (x.max() - x.min())
    for col, (lo, hi) in cfg.get("gaps", {}).items():
        if int(col) < y.shape[1]:
            y[(frac >= lo) & (frac < hi), int(col)] = np.nan
    return y


def serve_data(run):
    x, y, _ = T.serve_data(run.cfg, run.traffic, run.seed)
    return x, with_gaps(run.cfg, x, y)


def setup(run):
    """The served model (``state["model"]``, freed before the check), the
    hyperparameters its fit reached, whether ``precompute()`` cached the
    factors and each output's observed rows."""
    x, y = serve_data(run)
    model = run.estimator(x)
    model.fit(x, y, iters=int(run.cfg["iters"]))
    cached = bool(model.precompute())
    hypers = {k: np.asarray(v, float).reshape(-1).tolist()
              for k, v in model.get_variables().items()}
    observed = (~np.isnan(y)).sum(0).tolist()
    run.log(f"[setup] fitted {len(x)} rows, observed by output {observed}; precompute() "
            f"cached the factors: {cached}")
    return {"model": model, "hypers": hypers, "cached": cached, "observed": observed}


def call(run, state, req, record):
    """:func:`predict.call`, with the program's ``last_predict_report``
    where it has one and the observed rows the work counts read."""
    rec = predict.call(run, state, req, record)
    report = getattr(state["model"], "last_predict_report", None)
    if report is not None:
        rec["predict_report"] = dict(report)
    rec["observed"] = state["observed"]
    return rec


def work(run, rec):
    sz = dict(run.sizes(int(run.cfg["serve_rows"])), observed=rec["observed"])
    return predict_work(sz, rec["size"], int(run.cfg["samples"]))


def judge(run, state, items, candidate=None, log=None):
    """The numbers over ``items``, each a request with its ``outputs``.
    ``candidate(x_test, normals) -> outputs`` replaces the program's
    outputs (the control)."""
    cfg, device = run.cfg, run.device
    ref = check.Judge(cfg, device)
    x, y = serve_data(run)
    c = ref.condition(x, y, state["hypers"])
    std = c["std"].cpu().numpy()
    acc = {}
    for it in items:
        x_test = T.test_inputs(run.traffic, it["req"])
        nrm = check.normals(cfg, it["req"], len(x_test), device)
        want = ref.predict(c, x_test, nrm)
        got = it["outputs"] if candidate is None else candidate(x_test, nrm)
        v = check.pred_gap(got, want, std)
        if log is not None:
            cols = np.max(np.abs(np.asarray(got[0], float) - want[0]) / std, 0)
            log(f"[check] request {it['req']['k']} test inputs {len(x_test)}: pred_gap {v:.4g}; "
                f"mean gap by output {np.array2string(cols, precision=2)}")
        check.worst(acc, {"pred_gap": v})
    return acc


def control(run, state):
    low = check.lower(run.cfg, run.device)
    x, y = serve_data(run)
    c = low.condition(x, y, state["hypers"])
    return lambda x_test, nrm: low.predict(c, x_test, nrm)
