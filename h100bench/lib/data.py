"""The benchmark's data and model, frozen copies of ``chip_smoke.py``'s
``make_data`` / ``model_kwargs`` (themselves ``bench.py:40-69``), and the
SMSE arithmetic of ``gpar_torch/utils/metrics.py``.  Later changes to the
program cannot move them."""

import numpy as np


def make_data(n, p, seed):
    """The bench's synthetic closed-downwards chain: ``(x, y, f)``, float32,
    ``x`` sorted over [0, 10], ``f`` the noiseless truth, ``y = f`` plus
    0.05 standard-normal noise."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, size=n))
    cols = [np.sin(x) - x**2 / 50.0]
    for i in range(1, p):
        prev = cols[-1]
        cols.append(np.cos(prev) ** 2 + np.sin((i + 1) * x / 3.0) / (1 + i / 8.0))
    f = np.stack(cols, axis=1)
    y = f + 0.05 * rng.standard_normal((n, p))
    return x.astype(np.float32), y.astype(np.float32), f.astype(np.float32)


def model_kwargs(model, x):
    """The estimator's keyword arguments of a configuration's ``model``
    block; ``inducing`` points spread evenly over the data range, or the
    exact model (``x_ind=None``) where it is 0."""
    kw = {k: v for k, v in model.items() if k != "inducing"}
    m = int(model.get("inducing", 0))
    kw["x_ind"] = np.linspace(float(x.min()), float(x.max()), m) if m else None
    return kw


def smse(pred, target):
    """Per-column standardised MSE: MSE over the variance of the target."""
    pred = np.asarray(pred, dtype=float)
    target = np.asarray(target, dtype=float)
    den = np.mean((target - target.mean(0)) ** 2, axis=0)
    return np.mean((pred - target) ** 2, axis=0) / np.where(den > 0, den, np.nan)
