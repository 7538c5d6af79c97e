"""Shared helpers of the gpar_torch parity tests: the same inputs, made
from a seeded NumPy generator, go through the JAX package (the reference)
and its PyTorch port, and the results are compared as NumPy arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from .torch_cases import bench_kwargs, chain_data  # noqa: E402

__all__ = [
    "torch",
    "jax",
    "jnp",
    "np_",
    "close",
    "chain_data",
    "bench_kwargs",
    "jax_chain_normals",
    "jax_missing_normals",
    "jax_restart_normals",
    "close_tail",
]


def np_(a):
    """NumPy view of a torch tensor, JAX array or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(a, b, rtol, atol=0.0):
    assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


def jax_chain_normals(key, p, n, num_samples=None, dtype=jnp.float64, noise=False):
    """The standard normals the JAX package's ``_sample_chain`` draws from
    ``key`` (``gpar_tpu/models/gpar.py:408`` splits the key in three per
    layer; ``FDD.sample``, ``gpar_tpu/gp/core.py:264``, draws (n,) normals
    from the first subkey).  With ``num_samples`` the key is first split
    into one key per sample, as the estimator's sampling program does;
    returns (p, n) or (p, num_samples, n).  With ``noise`` also the normals
    of the second subkey, the noise a latent draw feeds forward
    (``gpar.py:414``), as a second array of the same shape."""

    def one(k):
        out, out2 = [], []
        for _ in range(p):
            k, k1, k2 = jax.random.split(k, 3)
            out.append(np.asarray(jax.random.normal(k1, (n,), dtype=dtype)))
            out2.append(np.asarray(jax.random.normal(k2, (n,), dtype=dtype)))
        return np.stack(out), np.stack(out2)

    if num_samples is None:
        z1, z2 = one(key)
    else:
        pairs = [one(k) for k in jax.random.split(key, num_samples)]
        z1, z2 = (np.stack([q[i] for q in pairs], axis=1) for i in (0, 1))
    return (z1, z2) if noise else z1


def jax_missing_normals(key, y, dtype=jnp.float64):
    """The standard normals the JAX package's ``GPAR.logpdf(sample_missing=
    True)`` draws from ``key`` for data ``y`` (n, p): one (n_missing,)
    vector per layer before the last whose rows under the routing that
    keeps them (``per_output(keep=True)``) miss its output, each from a
    subkey split off only at such a layer (``gpar_tpu/models/gpar.py:
    269-283``; ``FDD.sample``, ``gpar_tpu/gp/core.py:264``)."""
    from gpar_torch.models.gpar import per_output

    out = []
    items = list(per_output(y, np.ones_like(y), keep=True))[:-1]
    for yi, _, _ in items:
        n_missing = int(np.isnan(yi).sum())
        if n_missing:
            key, k = jax.random.split(key)
            out.append(np.array(jax.random.normal(k, (n_missing,), dtype=dtype)))
    return out


def jax_restart_normals(key, route, p, restarts, width, dtype=jnp.float64):
    """The standard normals of the restart perturbations the JAX package
    draws from ``key`` for a fit with ``restarts`` starts per layer, one
    (restarts - 1, width) array per layer (``lbfgs_traced_restarts`` draws
    ``normal(key, (restarts - 1, d))``, ``gpar_tpu/params/optim.py:73``),
    in the port's ``fit(restart_normals=...)`` form.  Each route keys its
    layers its own way:

    - ``"scan"`` (``fused=True``, ``fix=True``) and ``"batched"``: layer
      ``pi`` takes ``split(key, p)[pi]`` (``_fit_layer_keys``,
      ``gpar_tpu/models/regressor.py:1455-1460``), ``width`` the padded
      span ``s_max``;
    - ``"joint"`` (``fix=False``, fused): position ``pi`` takes the same
      split, ``width`` the prefix span ``n_z``;
    - ``"layer"`` (``fused=False``): layer ``pi`` takes ``fold_in(key, pi)``
      (``regressor.py:1262-1269``), ``width`` a list of the optimised
      latents' counts per layer;
    - ``"unroll"`` (``fused="unroll"``): layer ``pi`` takes
      ``split(key, p)[pi]`` (``regressor.py:1455-1460``), ``width`` a list
      of the optimised latents' counts per position."""
    if route in ("scan", "batched", "joint", "unroll"):
        keys = list(jax.random.split(key, p))
    elif route == "layer":
        keys = [jax.random.fold_in(key, pi) for pi in range(p)]
    else:
        raise ValueError(route)
    widths = list(width) if route in ("layer", "unroll") else [width] * p
    return [np.asarray(jax.random.normal(k, (restarts - 1, w), dtype=dtype))
            for k, w in zip(keys, widths)]


def close_tail(got, want, normals, latent, rtol=1e-8, atol=1e-10):
    """A predict tail's ``(batch, mean_chain)`` against the reference's,
    drawn from the same standard normals ``normals`` (p, S, n).  The means
    and, observed (``latent=False``), the draws agree to ``rtol``.  A latent
    posterior covariance can be near-singular (condition ~1 / jitter), and
    its Cholesky factor is then fixed only up to rounding in the near-null
    directions: the two factors differ while their products agree.  So for
    ``latent=True`` each layer's factor is recovered from the draws
    (``batch - mean = Z F^T``, by least squares on ``Z``, which needs S >= n)
    and the covariances ``F F^T`` are compared, to ``rtol`` of their largest
    entry."""
    (batch_t, mean_t), (batch_j, mean_j) = [tuple(map(np_, x)) for x in (got, want)]
    close(mean_t, mean_j, rtol=rtol, atol=atol)
    if not latent:
        close(batch_t, batch_j, rtol=rtol, atol=atol)
        return
    for pi, Z in enumerate(np_(normals)):
        assert Z.shape[0] >= Z.shape[1], "recovering the factor needs S >= n"
        covs = []
        for batch, mean in ((batch_t, mean_t), (batch_j, mean_j)):
            Ft = np.linalg.lstsq(Z, batch[:, :, pi] - mean[None, :, pi], rcond=None)[0]
            covs.append(Ft.T @ Ft)
        close(covs[0], covs[1], rtol=0, atol=rtol * np.max(np.abs(covs[1])))
