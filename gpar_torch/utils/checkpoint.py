"""Checkpoint and restore of a :class:`~gpar_torch.GPARRegressor`.

The port of ``gpar_tpu/utils/checkpoint.py``: the estimator's state (the
hyperparameters' latents and transforms, the conditioned data, the
normaliser statistics, the model configuration and the greedy output
order) as a plain dict of NumPy arrays and Python values, pickled.  The
format is the JAX package's (``format_version`` 1, the same keys), so a
file written by either package loads in the other.  Transform functions
are not serialised: pass ``transform_y`` again on load.

Only unpickle files this program or the JAX package wrote: unpickling can
run arbitrary code.
"""

import pickle

import numpy as np
import torch

from ..params.store import _Bounded, _Identity, _LowerBounded

__all__ = ["state_dict", "load_state_dict", "save", "load"]


def _np(a):
    return None if a is None else a.detach().cpu().numpy()


def state_dict(reg):
    """The serialisable state of ``reg`` (the JAX package's layout)."""
    vs_state = {
        name: {"latent": _np(reg.vs._latents[name]),
               "transform": _transform_state(reg.vs._transforms[name])}
        for name in reg.vs.names
    }
    data_state = None
    if reg.is_conditioned:
        data_state = {"x": reg._x_np, "y": reg._y_np, "w": reg._w_np}
    return {
        "format_version": 1,
        "model_config": dict(reg.model_config),
        "replace": reg.replace,
        "impute": reg.impute,
        "x_ind": _np(reg.x_ind),
        "normalise_y": reg.normalise_y,
        "compat": reg.compat,
        "vs": vs_state,
        "data": data_state,
        "norm_stats": None if reg._means is None else {"means": reg._means, "stds": reg._stds},
        "order": None if reg.order is None else np.asarray(reg.order),
    }


def _transform_state(t):
    if isinstance(t, _Identity):
        return ("identity",)
    if isinstance(t, _LowerBounded):
        return ("lower", float(t.lower))
    if isinstance(t, _Bounded):
        return ("bounded", float(t.lower), float(t.upper))
    raise TypeError(f"Unknown transform {t!r}")


def _transform_from_state(s):
    if s[0] == "identity":
        return _Identity()
    if s[0] == "lower":
        return _LowerBounded(s[1])
    if s[0] == "bounded":
        return _Bounded(s[1], s[2])
    raise ValueError(f"Unknown transform state {s!r}")


def load_state_dict(state, transform_y=None, device=None):
    """A :class:`~gpar_torch.GPARRegressor` rebuilt from :func:`state_dict`
    output (of either package) on ``device`` (default ``config.device``, the
    card), in ``config.dtype``.  ``transform_y`` must be given again where
    the saved model used a data transform other than the identity.  The
    conditioned data is restored from the host arrays; no posterior factors
    are cached."""
    from ..models.regressor import GPARRegressor

    reg = GPARRegressor(
        replace=state["replace"],
        impute=state["impute"],
        x_ind=state["x_ind"],
        normalise_y=state["normalise_y"],
        compat=state.get("compat", True),
        device=device,
        **({} if transform_y is None else {"transform_y": transform_y}),
        **state["model_config"],
    )
    order = state.get("order")
    reg.order = None if order is None else np.asarray(order)
    for name, entry in state["vs"].items():
        reg.vs._transforms[name] = _transform_from_state(entry["transform"])
        reg.vs._latents[name] = torch.as_tensor(
            np.asarray(entry["latent"], dtype=reg._np_dtype), device=reg.device)

    if state["data"] is not None:
        d = state["data"]
        x = np.asarray(d["x"], dtype=reg._np_dtype)
        reg.n, reg.m = x.shape
        reg.p = np.shape(d["y"])[1]
        reg._x_np, reg.x = x, reg._upload(x)
        reg._set_outputs(np.asarray(d["y"], dtype=reg._np_dtype),
                         np.asarray(d["w"], dtype=reg._np_dtype))
        reg.is_conditioned = True
        stats = state.get("norm_stats")
        if stats is not None:
            reg._means = np.asarray(stats["means"], dtype=reg._np_dtype)
            reg._stds = np.asarray(stats["stds"], dtype=reg._np_dtype)
    return reg


def save(reg, path):
    """Pickle the state of ``reg`` to ``path``."""
    with open(path, "wb") as f:
        pickle.dump(state_dict(reg), f)


def load(path, transform_y=None, device=None):
    """The estimator saved at ``path`` by :func:`save` (of either package)."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    return load_state_dict(state, transform_y=transform_y, device=device)
