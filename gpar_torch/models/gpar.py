"""GPAR model core — the autoregressive layer chain.

Port of ``gpar_tpu/models/gpar.py`` (behavioural rebuild of the reference
``gpar/model.py``): closed-downwards data routing (``per_output``),
conditioning (``|``), logpdf accumulation with resumable inputs, ancestral
sampling and the impute/replace input-updating rules.

Row masks derive from the data's NaN pattern and are planned on the host in
NumPy; ``y``/``w`` observations may be NumPy arrays (host) or tensors, and
are moved to the inputs' device where a layer uses them.  Samplers take
their standard normals from the caller (or draw them from a
``torch.Generator``), so a test can feed the JAX package's own draws.
"""

import numpy as np
import torch

from ..gp.core import Obs, PseudoObs, condition

__all__ = ["GPAR", "merge", "construct_model", "last", "per_output", "take_rows"]


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _nan_mask_col0(y):
    """Host-side NaN mask of a column array's first column."""
    return np.isnan(_host(y)[:, 0])


def _like(a, x):
    """``a`` as a tensor of ``x``'s dtype on ``x``'s device."""
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def take_rows(x, mask):
    """Row-filter by a host boolean mask (``x[mask]``,
    ``gpar/model.py:165``); NumPy stays NumPy."""
    mask = np.asarray(mask, dtype=bool)
    if isinstance(x, np.ndarray):
        return x[mask]
    idx = torch.as_tensor(np.nonzero(mask)[0], device=x.device)
    return x.index_select(0, idx)


def merge(x, updates, to_update):
    """Merge ``updates`` into ``x`` where ``to_update`` is True, preserving
    order (``gpar/model.py:14-44``): concatenate, then gather."""
    to_update = np.asarray(to_update, dtype=bool)
    n_keep = int((~to_update).sum())
    concat = torch.cat([take_rows(x, ~to_update), updates], dim=0)
    indices = np.empty(len(to_update), dtype=np.int64)
    indices[~to_update] = np.arange(n_keep)
    indices[to_update] = n_keep + np.arange(int(to_update.sum()))
    return concat.index_select(0, torch.as_tensor(indices, device=concat.device))


def construct_model(f, noise):
    """Wrap ``(f, noise)`` in a zero-arg constructor (``gpar/model.py:47-57``)."""
    return lambda: (f, noise)


def last(xs, select=None):
    """Pair each element of ``xs`` with an is-last flag, optionally only at
    the positions in ``select`` (``gpar/model.py:60-93``)."""
    items = list(xs)
    n = len(items)
    positions = range(n) if select is None else sorted(set(select) & set(range(n)))
    for i in positions:
        yield i == n - 1, items[i]


def per_output(y, w, keep=False):
    """Observations per output with closed-downwards filtering
    (``gpar/model.py:325-368``): yields ``(y[mask, i:i+1], w[mask, i],
    mask)`` per output ``i``, ``mask`` relative to the previous layer's
    rows.  ``keep=True`` keeps rows where a later output is observed.
    A dict ``{keep: [items]}`` as ``y`` replays precomputed items."""
    if isinstance(y, dict):
        yield from y[keep]
        return
    p = y.shape[1]
    available = ~np.isnan(_host(y))
    for i in range(p):
        mask = available[:, i].copy()
        if keep and i < p - 1:
            mask = mask | available[:, i + 1 :].any(axis=1)
        yield take_rows(y, mask)[:, i : i + 1], take_rows(w, mask)[:, i], mask
        y = take_rows(y, mask)
        w = take_rows(w, mask)
        available = available[mask]


class GPAR:
    """Basic GPAR model (``gpar/model.py:96-322``).

    Args:
        replace: Condition on predictive means instead of the data.
        impute: Impute missing points with predictive means.
        x_ind: Inducing-point inputs for the sparse (Titsias) scheme.
    """

    def __init__(self, replace=False, impute=False, x_ind=None):
        self.replace = replace
        self.impute = impute
        self.layers = []
        self.sparse = x_ind is not None
        self.x_ind = x_ind

    def copy(self):
        return GPAR(replace=self.replace, impute=self.impute, x_ind=self.x_ind)

    def add_layer(self, model_constructor):
        gpar = self.copy()
        gpar.layers = list(self.layers) + [model_constructor]
        return gpar

    def __or__(self, x_y_w):
        """Condition on data ``(x, y, w)`` (``gpar/model.py:148-176``)."""
        x, y, w = x_y_w
        gpar, x_ind = self.copy(), self.x_ind
        for is_last, ((yi, wi, mask), model) in last(
            zip(per_output(y, w, keep=self.impute), self.layers)
        ):
            x = take_rows(x, mask)
            f, noise = model()
            obs = self._obs(x, x_ind, yi, wi, f, noise)
            gpar.layers.append(construct_model(condition(f, obs), noise))
            if not is_last:
                x, x_ind = self._update_inputs(x, x_ind, yi, f, obs)
        return gpar

    def logpdf(
        self,
        x,
        y,
        w,
        only_last_layer=False,
        sample_missing=False,
        return_inputs=False,
        x_ind=None,
        outputs=None,
        normals=None,
        generator=None,
    ):
        """The log-density (``gpar/model.py:178-243``), including the
        resumable-inputs path behind ``fit(fix=True)``
        (``return_inputs``/``x_ind``/``outputs``).

        With ``sample_missing`` every layer but the last keeps the rows
        where a later output is observed, and before the next layer its
        missing outputs are filled with one draw of the layer's posterior
        given its observations, ``condition(f, obs)(x_missing, noise /
        w_missing)``.  The draws' standard normals come from ``normals``,
        one vector per layer that draws, in order (the JAX package splits
        its key only at such a layer), else from ``generator``."""
        logpdf = x.new_zeros(())
        x_ind = self.x_ind if x_ind is None else x_ind
        normals = None if normals is None else iter(normals)
        y_per_output = per_output(y, w, keep=self.impute or sample_missing)
        for is_last, ((yi, wi, mask), model) in last(zip(y_per_output, self.layers), select=outputs):
            x = take_rows(x, mask)
            f, noise = model()
            obs = self._obs(x, x_ind, yi, wi, f, noise)
            if not only_last_layer or is_last:
                logpdf = logpdf + obs.logpdf
            if not is_last:
                missing = _nan_mask_col0(yi)
                available = ~missing
                if sample_missing and missing.any():
                    x_miss = take_rows(x, missing)
                    z = None
                    if normals is not None:
                        z = next(normals, None)
                        if z is None:
                            raise ValueError("sample_missing: `normals` needs one vector per layer "
                                             "that draws")
                        z = _like(z, x)
                    draw = condition(f, obs)(x_miss, noise / _like(take_rows(wi, missing), x))
                    yi = merge(_like(yi, x), draw.sample(z, generator=generator), missing)
                    available = np.ones_like(missing)
                x, x_ind = self._update_inputs(x, x_ind, yi, f, obs, available=available)
        return (x, x_ind) if return_inputs else logpdf

    def sample(self, x, w, normals, latent=False, noise_normals=None):
        """One ancestral sample at inputs ``x`` (``gpar/model.py:245-277``)
        from caller-supplied standard normals ``normals`` of shape
        (p, n) (and ``noise_normals`` for ``latent=True``)."""
        noise_normals = None if noise_normals is None else noise_normals[:, None]
        return self.sample_batch(x, w, normals[:, None], latent, noise_normals)[0]

    def sample_batch(self, x, w, normals, latent=False, noise_normals=None):
        """``S`` ancestral samples at inputs ``x`` (n, m) with weights ``w``
        (n, p), one :func:`_sample_chain` per sample
        (``gpar_tpu/models/gpar.py:323-350``, which ``vmap``s the chain
        over keys; the reference loops per sample in Python,
        ``gpar/regression.py:558-563``).  ``normals`` (p, S, n) are the
        draws' standard normals and ``noise_normals`` (same shape) those of
        the noise a latent draw feeds forward (needed only with ``latent``
        and without ``replace``).  Returns (S, n, p)."""
        models = [m() for m in self.layers]
        fs = tuple(f for f, _ in models)
        noises = tuple(n for _, n in models)
        return torch.stack([
            _sample_chain(fs, noises, x, w, self.x_ind, normals[:, s], latent=latent,
                          replace=self.replace, sparse=self.sparse,
                          noise_normals=None if noise_normals is None else noise_normals[:, s])
            for s in range(normals.shape[1])
        ])

    def _obs(self, x, x_ind, y, w, f, noise):
        """Sparse or exact observations with NaN rows dropped
        (``gpar/model.py:279-289``)."""
        available = ~_nan_mask_col0(y)
        x = take_rows(x, available)
        y = _like(take_rows(y, available), x)
        w = _like(take_rows(w, available), x)
        if self.sparse:
            return PseudoObs(f(x_ind), f(x, noise / w), y)
        return Obs(f(x, noise / w), y)

    def _update_inputs(self, x, x_ind, y, f, obs, available=None):
        """Impute/replace outputs and append them as input columns
        (``gpar/model.py:291-322``); ``available`` (a host mask) stands in
        for ``y``'s NaN pattern where missing outputs were filled."""
        if available is None:
            available = ~_nan_mask_col0(y)

        def estimate(x_):
            return condition(f, obs).mean(x_)

        if self.sparse:
            x_ind = torch.cat([x_ind, estimate(x_ind)], dim=1)
        if self.impute and self.replace:
            y = estimate(x)
        else:
            y = _like(y, x)
            if self.impute and bool((~available).any()):
                y = merge(y, estimate(take_rows(x, ~available)), ~available)
            if self.replace and bool(available.any()):
                y = merge(y, estimate(take_rows(x, available)), available)
        return torch.cat([x, y], dim=1), x_ind


def _sample_chain(
    fs, noises, x, w, x_ind, normals, *, latent, replace, sparse, noise_normals=None
):
    """One ancestral pass through the layer chain (``gpar/model.py:245-277``)
    from standard normals ``normals`` (p, n); with ``latent`` the noisy
    sample feeds forward (from ``noise_normals`` (p, n)) and the noiseless
    one is returned; the noise is drawn only where the noisy sample feeds
    forward (``replace`` off, every layer but the last).  Returns (n, p)."""
    p = len(fs)
    cols = []
    for i, f in enumerate(fs):
        noise = noises[i]
        if latent:
            f_sample = f(x).sample(normals[i])
            cols.append(f_sample)
            if not replace and i < p - 1:
                noise_std = torch.sqrt(noise / w[:, i : i + 1])
                y_sample = f_sample + noise_std * noise_normals[i][:, None]
        else:
            y_sample = f(x, noise / w[:, i]).sample(normals[i])
            cols.append(y_sample)
        if i < p - 1:
            if sparse and x_ind is not None and x_ind.shape[0] > 0:
                x_ind = torch.cat([x_ind, f.mean(x_ind)], dim=1)
            y_next = f.mean(x) if replace else y_sample
            x = torch.cat([x, y_next], dim=1)
    return torch.cat(cols, dim=1)

