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
]


def np_(a):
    """NumPy view of a torch tensor, JAX array or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(a, b, rtol, atol=0.0):
    assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


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
