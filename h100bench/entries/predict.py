"""The ``predict`` entry: set-up fits one dataset of the configuration's
``serve_rows`` and calls ``precompute()``; each request is
``GPARRegressor.predict`` on fresh test inputs (the configuration's draws
and credible bounds, and normals from the request's seed).

The number compared with the reference, the worst over the requests
checked: ``pred_gap``, the widest gap between the program's predictive
mean, 2.5 % or 97.5 % bound and the reference's, over every test input and
output, in units of that output's training standard deviation.  The
reference conditions on the served dataset at the hyperparameters the
set-up's fit reached.
"""

import time

import numpy as np

from h100bench.lib import check
from h100bench.lib import traffic as T
from h100bench.lib.work import predict_work

FAULTS = ("half_samples", "altered")


def setup(run):
    """The served model (``state["model"]``, freed before the check), the
    hyperparameters its fit reached and whether ``precompute()`` cached
    the factors."""
    x, y, _ = T.serve_data(run.cfg, run.traffic, run.seed)
    model = run.estimator(x)
    model.fit(x, y, iters=int(run.cfg["iters"]))
    cached = bool(model.precompute())
    hypers = {k: np.asarray(v, float).reshape(-1).tolist()
              for k, v in model.get_variables().items()}
    run.log(f"[setup] fitted {len(x)} rows; precompute() cached the factors: {cached}")
    return {"model": model, "hypers": hypers, "cached": cached}


def call(run, state, req, record):
    cfg = run.cfg
    x_test = T.test_inputs(run.traffic, req)
    nrm = T.normals(cfg, req, len(x_test), run.device, run.dtype)
    t0 = time.perf_counter()
    out = state["model"].predict(x_test, num_samples=int(cfg["samples"]),
                                 credible_bounds=bool(cfg["credible_bounds"]), normals=nrm)
    return {"wall_s": time.perf_counter() - t0, "outputs": out}


def end_to_end(records, window_s):
    """``predict_p95_ms``: the 95th percentile of every request's latency;
    ``predicts_per_s``: requests completed per second of the window."""
    walls = np.array([r["wall_s"] for r in records])
    return {"predict_p95_ms": float(1e3 * np.percentile(walls, 95)),
            "predicts_per_s": len(walls) / window_s}


def work(run, rec):
    return predict_work(run.sizes(int(run.cfg["serve_rows"])), rec["size"],
                        int(run.cfg["samples"]))


def judge(run, state, items, candidate=None, log=None):
    """The numbers over ``items``, each a request with its ``outputs``.
    ``candidate(x_test, normals) -> outputs`` replaces the program's
    outputs (the control)."""
    cfg, device = run.cfg, run.device
    ref = check.Judge(cfg, device)
    x, y, _ = T.serve_data(cfg, run.traffic, run.seed)
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
    x, y, _ = T.serve_data(run.cfg, run.traffic, run.seed)
    c = low.condition(x, y, state["hypers"])
    return lambda x_test, nrm: low.predict(c, x_test, nrm)
