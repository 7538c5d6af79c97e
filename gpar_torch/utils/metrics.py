"""Evaluation metrics (a copy of ``gpar_tpu/utils/metrics.py``, which the
port does not import) — replaces the ``wbml.metric`` usage in the reference
examples (SMSE at ``examples/paper/eeg.py:39-41``, MAE at
``examples/paper/jura.py:36``, train-mean-standardised SMSE inline at
``examples/paper/exchange.py:37-45``).

All metrics are NaN-aware per column: entries where the target is missing
are ignored (the EEG test frame is sparse).
"""

import numpy as np

__all__ = ["mse", "smse", "mae", "rmse", "smse_train_mean"]


def _colwise(fn, pred, target):
    pred = np.asarray(pred, dtype=float)
    target = np.asarray(target, dtype=float)
    if pred.ndim == 1:
        pred = pred[:, None]
        target = target[:, None]
    out = np.full(pred.shape[1], np.nan)
    for i in range(pred.shape[1]):
        mask = ~np.isnan(target[:, i])
        if mask.any():
            out[i] = fn(pred[mask, i], target[mask, i])
    return out


def mse(pred, target):
    """Per-column mean squared error (NaN targets ignored)."""
    return _colwise(lambda p, t: np.mean((p - t) ** 2), pred, target)


def mae(pred, target):
    """Per-column mean absolute error (NaN targets ignored)."""
    return _colwise(lambda p, t: np.mean(np.abs(p - t)), pred, target)


def rmse(pred, target):
    """Per-column root mean squared error."""
    return np.sqrt(mse(pred, target))


def smse(pred, target):
    """Standardised MSE: MSE(pred) / MSE(test-mean predictor).

    The wbml definition used by the EEG and Jura experiments: normalises by
    the variance of the test targets themselves.
    """

    def one(p, t):
        denom = np.mean((t - np.mean(t)) ** 2)
        return np.mean((p - t) ** 2) / denom if denom > 0 else np.nan

    return _colwise(one, pred, target)


def smse_train_mean(pred, target, train_mean):
    """SMSE standardised by the *training* mean predictor — the exchange
    experiment's inline variant (``examples/paper/exchange.py:37-45``)."""
    pred = np.atleast_2d(np.asarray(pred, dtype=float).T).T
    target = np.atleast_2d(np.asarray(target, dtype=float).T).T
    train_mean = np.broadcast_to(np.asarray(train_mean, dtype=float), target.shape[1:])
    out = np.full(pred.shape[1], np.nan)
    for i in range(pred.shape[1]):
        mask = ~np.isnan(target[:, i])
        if mask.any():
            num = np.mean((pred[mask, i] - target[mask, i]) ** 2)
            den = np.mean((train_mean[i] - target[mask, i]) ** 2)
            out[i] = num / den if den > 0 else np.nan
    return out
