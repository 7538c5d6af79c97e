"""Plain PyTorch reference of the exchange-rate GPAR: rational-quadratic and
linear kernels, outputs with gaps, and the ``replace=False`` predictive of
per-sample ancestral chains.

GPAR (Requeima et al., arXiv:1802.07182), the exchange-rate experiment
(``examples/paper/exchange.py:21-31`` of the reference GPAR): output ``i``
is a GP whose inputs are ``x`` and the outputs before it, with

    k_i(a, b) = v_i RQ_{alpha_i}(|a_x - b_x| / s_i)
                + (a_y / l_i) . (b_y / l_i)
                + u_i RQ_{beta_i}(|(a_y - b_y) / q_i|),
    RQ_alpha(r) = (1 + r^2 / (2 alpha))^(-alpha)

(``gpar/regression.py:92-182`` with ``rq``, ``linear`` and ``nonlinear``
on), the exact marginal likelihood (no inducing points), ``impute`` and
``normalise_y`` on and ``replace`` off.  This file writes that mathematics
once, with plain ``torch`` operations and no kernel, cache, bucket, mask or
batching, and imports nothing of the program under test.

The rules of ``gpar/model.py`` it follows, and how:

- Layer ``i`` is conditioned on the rows where output ``i`` is observed,
  and on those alone (its own factorisation of that many rows).  Under
  ``impute`` the closed-downwards routing of ``gpar/model.py:325-368``
  drops a row from layer ``i`` only where output ``i`` and every later
  output are missing, so it drops no observed value: the observed rows are
  the whole of it.
- The column fed to the next layer (``gpar/model.py:291-322``) is the
  observed output where there is one and, where there is a gap, the
  layer's posterior mean at that row (``impute``).
- Prediction (``replace=False``, ``gpar/model.py:245-277``): every sample
  is its own chain.  At each layer the sample's test inputs (``x`` and its
  earlier draws) give the exact posterior mean and covariance, the noise
  floored at the jitter goes on the diagonal (``latent=False``), and the
  draw is ``mean + F z`` with ``F`` the sampling factor and ``z`` the given
  standard normals; the draw is appended to that sample's test inputs.
  One sample is worked at a time, so that the cross-covariances of a
  4400-row layer fit in memory.

Numerics the configuration states are applied as stated: the jitter is
added to the diagonal before every factorisation, with the escalating
retries of ``RETRY_FACTORS`` and then the jitter relative to the diagonal
(``reference/gpar.py``'s ladder, shared), and a sampling factor that no
rung repairs is the eigendecomposition with its eigenvalues clamped at the
jitter.  Noise variances are floored at the jitter.  The caller picks the
dtype.  Departures from ``gpar/model.py``: none in the mathematics; the
reference GPAR draws its normals itself, here they are given.
"""

import torch

from .gpar import LOG_2PI, NOISE_LOWER, _append, _lower, _sq_dists, _upper_t, chol, sample_factor

#: Initial value of every RQ exponent and its bounds (``gpar/regression.py:107,133``).
ALPHA_INIT, ALPHA_LOWER = 1e-2, 1e-3


def check_model(model):
    """The options this reference implements; anything else raises."""
    want = dict(linear=True, nonlinear=True, rq=True, impute=True, replace=False,
                normalise_y=True)
    for k, v in want.items():
        if model.get(k) != v:
            raise ValueError(f"the reference implements {k}={v}, not {model.get(k)!r}")
    if int(model.get("inducing", 0)):
        raise ValueError("the reference implements the exact model (no inducing points)")


def initial_hypers(model, p, m):
    """Layer ``i``'s initial hyperparameters as the estimator sets them
    (``gpar/regression.py:92-173``), name -> list of floats."""
    out = {}
    for i in range(p):
        out[f"{i}/input/var"] = [1.0]
        out[f"{i}/input/scales"] = [float(model["scale"])] * m
        out[f"{i}/input/alpha"] = [ALPHA_INIT]
        if i > 0:
            out[f"{i}/output/lin/scales"] = [float(model["linear_scale"])] * i
            out[f"{i}/output/nonlin/var"] = [1.0]
            out[f"{i}/output/nonlin/scales"] = [float(model["nonlinear_scale"])] * i
            out[f"{i}/output/nonlin/alpha"] = [ALPHA_INIT]
        out[f"{i}/noise"] = [float(model["noise"])]
    return out


def layer_names(i):
    """Layer ``i``'s hyperparameter names and their lower bounds."""
    names = [(f"{i}/input/var", 0.0), (f"{i}/input/scales", 0.0), (f"{i}/input/alpha", ALPHA_LOWER)]
    if i > 0:
        names += [(f"{i}/output/lin/scales", 0.0), (f"{i}/output/nonlin/var", 0.0),
                  (f"{i}/output/nonlin/scales", 0.0), (f"{i}/output/nonlin/alpha", ALPHA_LOWER)]
    return names + [(f"{i}/noise", NOISE_LOWER)]


def normalise(y):
    """Per-column mean and standard deviation (ddof 1) over the observed
    values (a gap is NaN), and the normalised outputs, gaps kept as NaN."""
    obs = ~torch.isnan(y)
    count = obs.sum(0, keepdim=True).to(y.dtype)
    filled = torch.where(obs, y, torch.zeros_like(y))
    mean = filled.sum(0, keepdim=True) / count
    dev = torch.where(obs, y - mean, torch.zeros_like(y))
    std = torch.sqrt((dev * dev).sum(0, keepdim=True) / torch.clamp_min(count - 1, 1))
    std = torch.where(std > 0, std, torch.ones_like(std))
    return (y - mean) / std, mean, std


def _rq(var, alpha, d2):
    return var * (1.0 + d2 / (2.0 * alpha)) ** (-alpha)


def gram(h, a, b, i, m):
    """Layer ``i``'s kernel between the rows of ``a`` and ``b`` (each
    ``m + i`` wide: ``x``, then the previous outputs)."""
    s = h[f"{i}/input/scales"]
    k = _rq(h[f"{i}/input/var"], h[f"{i}/input/alpha"], _sq_dists(a[:, :m] / s, b[:, :m] / s))
    if i > 0:
        ay, by = a[:, m:m + i], b[:, m:m + i]
        lin, q = h[f"{i}/output/lin/scales"], h[f"{i}/output/nonlin/scales"]
        k = k + (ay / lin) @ (by / lin).T
        k = k + _rq(h[f"{i}/output/nonlin/var"], h[f"{i}/output/nonlin/alpha"],
                    _sq_dists(ay / q, by / q))
    return k


def layer_nll(h, i, m, x_obs, y_obs, jitter):
    """Layer ``i``'s exact negative log marginal likelihood of its observed
    outputs ``y_obs`` at their inputs ``x_obs``, ``-log N(y | 0, K + D)``
    with ``D`` the noise floored at the jitter, and its posterior factors."""
    n = y_obs.shape[0]
    noise = torch.clamp_min(h[f"{i}/noise"], jitter)
    K = gram(h, x_obs, x_obs, i, m)
    L = chol(K + noise * torch.eye(n, dtype=K.dtype, device=K.device), jitter)
    v = _lower(L, y_obs[:, None])[:, 0]
    nll = 0.5 * n * LOG_2PI + torch.log(torch.diagonal(L)).sum() + 0.5 * (v * v).sum()
    alpha = _upper_t(L, v[:, None])[:, 0]
    return nll, {"L": L, "alpha": alpha, "x_obs": x_obs}


def condition(hypers, x, yn, z, jitter, start_hypers=None, grads=False):
    """The chain conditioned on normalised outputs ``yn`` (n, p), NaN at
    the gaps, at ``hypers``: per layer its NLL on its observed rows and its
    posterior factors, then the column fed forward (the observed output,
    or at a gap the layer's posterior mean at that row).

    ``start_hypers``: each layer's NLL also at these, with the same inputs.
    ``z`` (inducing inputs) must be None and ``grads`` False: the exact
    model's value is what this configuration's cells compare.

    Returns ``{"nll": [...], "layers": [(h, factors), ...], "nll0": [...]}``."""
    if z is not None or grads:
        raise ValueError("the reference computes the exact model's values only")
    dt, dev = x.dtype, x.device
    m, p = x.shape[1], yn.shape[1]
    x_aug = x
    out = {"nll": [], "layers": [], "nll0": []}

    def values(source, i):
        return {name: torch.as_tensor(source[name], dtype=dt, device=dev).reshape(-1)
                for name, _ in layer_names(i)}

    for i in range(p):
        obs = ~torch.isnan(yn[:, i])
        x_obs, y_obs = x_aug[obs], yn[obs, i]
        h = values(hypers, i)
        nll, fac = layer_nll(h, i, m, x_obs, y_obs, jitter)
        out["nll"].append(float(nll))
        out["layers"].append((h, fac))
        if start_hypers is not None:
            out["nll0"].append(float(layer_nll(values(start_hypers, i), i, m, x_obs, y_obs,
                                               jitter)[0]))
        est = gram(h, x_aug, x_obs, i, m) @ fac["alpha"]
        x_aug = _append(x_aug, torch.where(obs, yn[:, i], est))
    return out


def predict(layers, x_test, normals, y_mean, y_std, jitter, quantiles=(0.025, 0.975),
            replace=False):
    """The ``replace=False`` predictive at ``x_test`` (t, m) from the
    conditioned ``layers``: sample ``s`` runs its own chain through every
    layer (the posterior at its own test inputs, the noise on the
    diagonal, the draw ``mean + normals[i, s] @ F^T``, appended to its
    inputs).  ``replace=True`` appends the posterior mean instead, the
    other mode, for the tests that tell the two apart.  The draws are
    mapped back through the normalisation; returns their mean and
    ``quantiles`` (linear interpolation), each (t, p)."""
    dt, dev = x_test.dtype, x_test.device
    m, t = x_test.shape[1], x_test.shape[0]
    eye = torch.eye(t, dtype=dt, device=dev)
    chains = []
    for s in range(normals.shape[1]):
        xt, draws = x_test, []
        for i, (h, fac) in enumerate(layers):
            Kxt = gram(h, fac["x_obs"], xt, i, m)
            V = _lower(fac["L"], Kxt)
            cov = gram(h, xt, xt, i, m) - V.T @ V
            noise = torch.clamp_min(h[f"{i}/noise"], jitter)
            mean = Kxt.T @ fac["alpha"]
            draws.append(mean + sample_factor(cov + noise * eye, jitter) @ normals[i, s])
            xt = _append(xt, mean if replace else draws[-1])
        chains.append(torch.stack(draws, dim=-1))
    batch = torch.stack(chains) * y_std + y_mean  # (S, t, p)
    q = torch.tensor(quantiles, dtype=dt, device=dev)
    lo, hi = torch.quantile(batch, q, dim=0, interpolation="linear")
    return batch.mean(0), lo, hi
