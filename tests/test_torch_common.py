"""Shared helpers of the gpar_torch parity tests: the same inputs, made
from a seeded NumPy generator, go through the JAX package (the reference)
and its PyTorch port, and the results are compared as NumPy arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

__all__ = [
    "torch",
    "jax",
    "jnp",
    "np_",
    "close",
    "chain_data",
    "bench_kwargs",
    "jax_chain_normals",
]


def np_(a):
    """NumPy view of a torch tensor, JAX array or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(a, b, rtol, atol=0.0):
    assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


def chain_data(n=100, p=3, seed=0, n_test=20):
    """A small closed-downwards chain shaped like the benchmark's data
    (each output a nonlinear function of the previous one and the input)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    cols = [np.sin(x) - x**2 / 50.0]
    for i in range(1, p):
        cols.append(np.cos(cols[-1]) ** 2 + np.sin((i + 1) * x / 3.0) / (1 + i / 8.0))
    y = np.stack(cols, axis=1) + 0.05 * rng.standard_normal((n, p))
    x_test = np.linspace(0.2, 9.8, n_test)
    return x, y, x_test


def bench_kwargs(n_ind=8, lo=0.0, hi=10.0):
    """The benchmark's model configuration (``bench.py:54-69``) with
    ``n_ind`` inducing points."""
    return dict(
        scale=0.2,
        linear=True,
        linear_scale=10.0,
        nonlinear=True,
        nonlinear_scale=1.0,
        noise=0.1,
        impute=True,
        replace=True,
        normalise_y=True,
        x_ind=np.linspace(lo, hi, n_ind),
    )


def jax_chain_normals(key, p, n, num_samples=None, dtype=jnp.float64):
    """The standard normals the JAX package's ``_sample_chain`` draws from
    ``key`` (``gpar_tpu/models/gpar.py:408`` splits the key in three per
    layer; ``FDD.sample``, ``gpar_tpu/gp/core.py:264``, draws (n,) normals
    from the first subkey).  With ``num_samples`` the key is first split
    into one key per sample, as the estimator's sampling program does;
    returns (p, n) or (p, num_samples, n)."""

    def one(k):
        out = []
        for _ in range(p):
            k, k1, _ = jax.random.split(k, 3)
            out.append(np.asarray(jax.random.normal(k1, (n,), dtype=dtype)))
        return np.stack(out)

    if num_samples is None:
        return one(key)
    keys = jax.random.split(key, num_samples)
    return np.stack([one(k) for k in keys], axis=1)
