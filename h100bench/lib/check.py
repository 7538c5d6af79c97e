"""What the entries' comparisons with the plain reference share
(``h100bench/reference/``): the reference run in a dtype on a device, the
gap of two predictives, and the verdict over each number's limit.  Each
entry (``h100bench/entries/<entry>.py``) judges its own requests with
these.

The reference runs in float64 with TF32 off.  The control is the reference
itself in the precision below the configuration's, put in the program's
place: float32, with TF32 off, for a float64 configuration.
"""

import contextlib
import importlib

import numpy as np

from . import traffic as T
from .data import model_kwargs

#: The precision below each configuration dtype that a control runs in.
LOWER = {"float64": "float32"}


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the block's float32 matmuls."""
    import torch

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def reference(cfg):
    return importlib.import_module(f"h100bench.reference.{cfg['reference']}")


class Judge:
    """Runs the reference of one configuration on ``device`` in ``dtype``."""

    def __init__(self, cfg, device, dtype_name="float64"):
        import torch

        self.cfg, self.device = cfg, device
        self.dtype = getattr(torch, dtype_name)
        self.R = reference(cfg)
        self.R.check_model(cfg["model"])
        self.jitter = float(cfg["jitter"])

    def _t(self, a):
        import torch

        a = torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)
        return a[:, None] if a.ndim == 1 else a

    def condition(self, x, y, hypers, start=False, grads=False):
        """The reference chain on ``(x, y)`` at ``hypers``; with ``start``
        each layer's NLL also at the initial hyperparameters; with ``grads``
        each layer's gradient norm (at both, with ``start``)."""
        cfg = self.cfg
        xi = model_kwargs(cfg["model"], x)["x_ind"]
        X, Y = self._t(x), self._t(y)
        yn, mean, std = self.R.normalise(Y)
        z = None if xi is None else self._t(xi)
        init = self.R.initial_hypers(cfg["model"], int(cfg["p"]), X.shape[1]) if start else None
        with no_tf32():
            c = self.R.condition(hypers, X, yn, z, self.jitter, start_hypers=init, grads=grads)
        c.update(mean=mean, std=std)
        return c

    def predict(self, c, x_test, normals):
        with no_tf32():
            out = self.R.predict(c["layers"], self._t(x_test), normals.to(self.dtype),
                                 c["mean"], c["std"], self.jitter)
        return [a.cpu().numpy() for a in out]


def lower(cfg, device):
    """The reference in the precision below the configuration's (the
    control's)."""
    if cfg["dtype"] not in LOWER:
        raise ValueError(f"no control precision below {cfg['dtype']}; known: {sorted(LOWER)}")
    return Judge(cfg, device, LOWER[cfg["dtype"]])


def normals(cfg, req, t, device):
    """A request's normals as the program got them, in its dtype."""
    import torch

    return T.normals(cfg, req, t, device, getattr(torch, cfg["dtype"]))


def pred_gap(got, want, std):
    """Widest gap of (mean, lo, hi) in units of each output's std."""
    s = np.asarray(std, dtype=float).reshape(1, -1)
    return max(float(np.max(np.abs(np.asarray(g, float) - np.asarray(w, float)) / s))
               for g, w in zip(got, want))


def worst(acc, one):
    """``acc`` updated with the larger of each number; NaN stays NaN."""
    for k, v in one.items():
        acc[k] = max(acc.get(k, 0.0), v) if np.isfinite(v) and np.isfinite(acc.get(k, 0.0)) \
            else float("nan")
    return acc


def verdict(numbers, limits):
    """``(correct, [(name, value, limit), ...])``: every number finite and
    within its limit."""
    rows = [(k, float(v), float(limits[k])) for k, v in numbers.items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
