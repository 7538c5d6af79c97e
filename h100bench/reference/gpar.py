"""Plain PyTorch reference of the GPAR chain that the benchmark's cells run.

GPAR (Requeima et al., arXiv:1802.07182) models output ``i`` with a GP
whose inputs are ``x`` and the outputs before it.  This file writes the
mathematics of the configurations under ``h100bench/configs/`` once, with
plain ``torch`` operations and no kernel, cache, bucket or batching: the
kernel tree's Gram, each layer's negative log marginal likelihood (the
collapsed Titsias bound with inducing inputs, or the exact one without),
the posterior means that feed the next layer, and the ``replace=True``
Monte-Carlo predictive from given standard normals.

It imports nothing of the program under test.  Its inputs are the
benchmark's own data and the hyperparameters to judge, as a name -> value
dict in the estimator's public naming (``"{i}/input/var"``, ...).

The model (``gpar/regression.py:72-182`` of the reference GPAR, with the
options the configurations use: one EQ term on ``x``, and for ``i > 0`` a
linear and an EQ term on the previous outputs; ``replace`` and ``impute``
on, data fully observed):

    k_i(a, b) = v_i exp(-|a_x - b_x|^2 / 2 s_i^2)
                + (a_y / l_i) . (b_y / l_i) + u_i exp(-|(a_y - b_y) / q_i|^2 / 2)

Numerics that the configuration states are applied as stated: ``jitter``
is added to the diagonal before every factorisation, with the escalating
retries of ``RETRY_FACTORS`` and then a jitter relative to the diagonal
when a factorisation fails; noise variances are floored at ``jitter``.  A
sampling factor that no rung repairs is the eigendecomposition with its
eigenvalues clamped at the jitter.  The caller picks the dtype.

Every positive hyperparameter is ``lower + exp(latent)``
(``gpar/regression.py:169-173``); :func:`condition` can also give each
layer's gradient norm with respect to those latents.
"""

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
#: Multiples of the jitter tried after a failed factorisation.
RETRY_FACTORS = (1e3, 1e6)
#: Lower bound of the noise variance, and of every other positive
#: hyperparameter (``gpar/regression.py:172``).
NOISE_LOWER = 1e-8


def check_model(model):
    """The options this reference implements; anything else raises."""
    want = dict(linear=True, nonlinear=True, impute=True, replace=True, normalise_y=True)
    for k, v in want.items():
        if model.get(k) != v:
            raise ValueError(f"the reference implements {k}={v}, not {model.get(k)!r}")


def initial_hypers(model, p, m):
    """Layer ``i``'s initial hyperparameters as the estimator sets them
    (``gpar/regression.py:92-173``), name -> list of floats."""
    out = {}
    for i in range(p):
        out[f"{i}/input/var"] = [1.0]
        out[f"{i}/input/scales"] = [float(model["scale"])] * m
        if i > 0:
            out[f"{i}/output/lin/scales"] = [float(model["linear_scale"])] * i
            out[f"{i}/output/nonlin/var"] = [1.0]
            out[f"{i}/output/nonlin/scales"] = [float(model["nonlinear_scale"])] * i
        out[f"{i}/noise"] = [float(model["noise"])]
    return out


def layer_names(i):
    """Layer ``i``'s hyperparameter names and their lower bounds (the
    estimator's constraints)."""
    names = [(f"{i}/input/var", 0.0), (f"{i}/input/scales", 0.0)]
    if i > 0:
        names += [(f"{i}/output/lin/scales", 0.0), (f"{i}/output/nonlin/var", 0.0),
                  (f"{i}/output/nonlin/scales", 0.0)]
    return names + [(f"{i}/noise", NOISE_LOWER)]


def normalise(y):
    """Per-column mean and standard deviation (ddof 1), and the normalised
    outputs."""
    mean = y.mean(0, keepdim=True)
    std = y.std(0, keepdim=True, unbiased=True)
    std = torch.where(std > 0, std, torch.ones_like(std))
    return (y - mean) / std, mean, std


#: Elements of the (rows, columns, width) difference tensor per block.
BLOCK = 1 << 25


def _sq_dists(a, b):
    """Squared distances between the rows of ``a`` and ``b``, from the
    differences themselves (no inner-product identity), in row blocks."""
    rows = max(1, BLOCK // max(1, b.shape[0] * a.shape[1]))
    return torch.cat([((a[r:r + rows, None, :] - b[None, :, :]) ** 2).sum(-1)
                      for r in range(0, a.shape[0], rows)])


def gram(h, a, b, i, m):
    """Layer ``i``'s kernel between the rows of ``a`` and ``b`` (each
    ``m + i`` wide: ``x``, then the previous outputs)."""
    s = h[f"{i}/input/scales"]
    k = h[f"{i}/input/var"] * torch.exp(-0.5 * _sq_dists(a[:, :m] / s, b[:, :m] / s))
    if i > 0:
        ay, by = a[:, m:m + i], b[:, m:m + i]
        lin = h[f"{i}/output/lin/scales"]
        q = h[f"{i}/output/nonlin/scales"]
        k = k + (ay / lin) @ (by / lin).T
        k = k + h[f"{i}/output/nonlin/var"] * torch.exp(-0.5 * _sq_dists(ay / q, by / q))
    return k


def kdiag(h, a, i, m):
    d = h[f"{i}/input/var"].expand(a.shape[0])
    if i > 0:
        d = d + ((a[:, m:m + i] / h[f"{i}/output/lin/scales"]) ** 2).sum(-1)
        d = d + h[f"{i}/output/nonlin/var"]
    return d


def chol(K, jitter):
    """Cholesky factor of ``K + e I``: ``e`` is the jitter, then its
    ``RETRY_FACTORS`` multiples, then ``max(1e-6 max|diag K|, jitter)``,
    the first rung that holds; NaN when every rung fails."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    rel = max(1e-6 * float(torch.diagonal(K).detach().abs().max()), jitter)
    for e in [jitter] + [jitter * f for f in RETRY_FACTORS] + [rel]:
        L, info = torch.linalg.cholesky_ex(K + e * eye)
        if int(info) == 0:
            return L
    return torch.full_like(K, float("nan"))


def sample_factor(C, jitter):
    """A factor ``F F^T ~= C`` for sampling: :func:`chol`, or where every
    rung fails the eigendecomposition with eigenvalues clamped at the
    jitter."""
    L = chol(C, jitter)
    if torch.isfinite(L).all():
        return L
    w, V = torch.linalg.eigh(C)
    return V * torch.sqrt(torch.clamp_min(w, jitter))[None, :]


def _lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _upper_t(L, B):
    return torch.linalg.solve_triangular(L.T, B, upper=True)


def layer_nll(h, i, m, x_aug, z_aug, y, jitter):
    """Layer ``i``'s negative log marginal likelihood of ``y`` (n,) at
    inputs ``x_aug`` and its posterior factors.  With inducing inputs
    ``z_aug`` the collapsed Titsias (2009) bound in its Woodbury form::

        Lm = chol(Kmm), A = Lm^-1 Kmn, LB = chol(I + A D^-1 A^T),
        -nll = -1/2 (n log 2 pi + log|D| + log|LB|^2 + y^T D^-1 (y - A^T w))
               - 1/2 sum((knn - diag A^T A) / D),  w = LB^-T LB^-1 A D^-1 y

    without them (``z_aug`` None) the exact ``-log N(y | 0, K + D)``.
    ``D`` is the noise variance floored at the jitter."""
    dt = x_aug.dtype
    noise = torch.clamp_min(h[f"{i}/noise"], jitter)
    n = y.shape[0]
    if z_aug is None:
        K = gram(h, x_aug, x_aug, i, m)
        L = chol(K + noise * torch.eye(n, dtype=dt, device=x_aug.device), jitter)
        v = _lower(L, y[:, None])[:, 0]
        nll = 0.5 * n * LOG_2PI + torch.log(torch.diagonal(L)).sum() + 0.5 * (v * v).sum()
        alpha = _upper_t(L, v[:, None])[:, 0]
        return nll, {"L": L, "alpha": alpha, "x_aug": x_aug, "est_rows": K @ alpha}
    Kmm = gram(h, z_aug, z_aug, i, m)
    Kmn = gram(h, z_aug, x_aug, i, m)
    Lm = chol(Kmm, jitter)
    A = _lower(Lm, Kmn)
    G = (A / noise) @ A.T
    LB = chol(0.5 * (G + G.T) + torch.eye(G.shape[0], dtype=dt, device=G.device), jitter)
    u = A @ (y / noise)
    w = _upper_t(LB, _lower(LB, u[:, None]))[:, 0]
    beta = _upper_t(Lm, w[:, None])[:, 0]
    trace = (torch.clamp_min(kdiag(h, x_aug, i, m) - (A * A).sum(0), 0.0) / noise).sum()
    quad = (y * (y - A.T @ w) / noise).sum()
    logdet = n * torch.log(noise) + 2.0 * torch.log(torch.diagonal(LB)).sum()
    nll = 0.5 * (n * LOG_2PI + logdet + quad) + 0.5 * trace
    return nll, {"Lm": Lm, "LB": LB, "beta": beta, "z_aug": z_aug,
                 "est_rows": Kmn.T @ beta, "est_ind": Kmm @ beta}


def _append(a, col):
    return torch.cat([a, col[:, None]], dim=1)


def layer_grad_norm(values, i, m, x_aug, z_aug, y, jitter):
    """The norm of the gradient of layer ``i``'s NLL at ``values`` (name ->
    list) with respect to the latents ``log(value - lower)`` of its
    hyperparameters, at fixed inputs."""
    dt, dev = x_aug.dtype, x_aug.device
    tiny = torch.finfo(dt).tiny
    lat, h = [], {}
    for name, lower in layer_names(i):
        v = torch.as_tensor(values[name], dtype=dt, device=dev).reshape(-1)
        z = torch.log(torch.clamp_min(v - lower, tiny)).requires_grad_(True)
        lat.append(z)
        h[name] = lower + torch.exp(z)
    with torch.enable_grad():
        nll, _ = layer_nll(h, i, m, x_aug.detach(), None if z_aug is None else z_aug.detach(),
                           y, jitter)
        grads = torch.autograd.grad(nll, lat)
    return float(torch.sqrt(sum((g * g).sum() for g in grads)))


def condition(hypers, x, yn, z, jitter, start_hypers=None, grads=False):
    """The chain conditioned on normalised outputs ``yn`` (n, p) at
    ``hypers``: per layer its NLL and posterior factors, then its posterior
    means at the data rows (and the inducing inputs ``z``, None for the
    exact model) appended as the next layer's input column.

    ``start_hypers``: each layer's NLL also at these, with the same inputs
    (the inputs a layer-by-layer fit started that layer from).  ``grads``:
    each layer's :func:`layer_grad_norm` at ``hypers`` (and at
    ``start_hypers``, where given), with the same inputs.

    Returns ``{"nll": [...], "layers": [(h, factors), ...], "nll0": [...],
    "grad": [...], "grad0": [...]}``."""
    dt, dev = x.dtype, x.device
    m, p = x.shape[1], yn.shape[1]
    x_aug, z_aug = x, z
    out = {"nll": [], "layers": [], "nll0": [], "grad": [], "grad0": []}

    def one(source, i):
        h = {name: torch.as_tensor(source[name], dtype=dt, device=dev).reshape(-1)
             for name, _ in layer_names(i)}
        nll, fac = layer_nll(h, i, m, x_aug, z_aug, yn[:, i], jitter)
        return float(nll), fac, h

    for i in range(p):
        nll, fac, h = one(hypers, i)
        out["nll"].append(nll)
        out["layers"].append((h, fac))
        if start_hypers is not None:
            out["nll0"].append(one(start_hypers, i)[0])
        if grads:
            out["grad"].append(layer_grad_norm(hypers, i, m, x_aug, z_aug, yn[:, i], jitter))
            if start_hypers is not None:
                out["grad0"].append(layer_grad_norm(start_hypers, i, m, x_aug, z_aug, yn[:, i],
                                                    jitter))
        x_aug = _append(x_aug, fac["est_rows"])
        if z_aug is not None:
            z_aug = _append(z_aug, fac["est_ind"])
    return out


def predict(layers, x_test, normals, y_mean, y_std, jitter, quantiles=(0.025, 0.975)):
    """The ``replace=True`` predictive at ``x_test`` (t, m) from the
    conditioned ``layers``: per layer the posterior mean and covariance at
    the test inputs plus the noise, ``mean + normals[i] @ F^T`` with ``F``
    the jittered Cholesky factor, and the posterior mean appended to the
    test inputs.  The draws are mapped back through the normalisation;
    returns their mean and ``quantiles`` (linear interpolation), each
    (t, p)."""
    dt, dev = x_test.dtype, x_test.device
    m, t = x_test.shape[1], x_test.shape[0]
    xt = x_test
    draws = []
    for i, (h, fac) in enumerate(layers):
        Ktt = gram(h, xt, xt, i, m)
        if "z_aug" in fac:
            Kmt = gram(h, fac["z_aug"], xt, i, m)
            mean = Kmt.T @ fac["beta"]
            T1 = _lower(fac["Lm"], Kmt)
            T2 = _lower(fac["LB"], T1)
            cov = Ktt - T1.T @ T1 + T2.T @ T2
        else:
            Kxt = gram(h, fac["x_aug"], xt, i, m)
            mean = Kxt.T @ fac["alpha"]
            V = _lower(fac["L"], Kxt)
            cov = Ktt - V.T @ V
        noise = torch.clamp_min(h[f"{i}/noise"], jitter)
        F = sample_factor(cov + noise * torch.eye(t, dtype=dt, device=dev), jitter)
        draws.append(mean[None, :] + normals[i] @ F.T)
        xt = _append(xt, mean)
    batch = torch.stack(draws, dim=-1) * y_std + y_mean  # (S, t, p)
    q = torch.tensor(quantiles, dtype=dt, device=dev)
    lo, hi = torch.quantile(batch, q, dim=0, interpolation="linear")
    return batch.mean(0), lo, hi
