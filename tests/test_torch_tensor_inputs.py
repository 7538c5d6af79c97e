"""Tensor inputs at gpar_torch's entry points, on the CPU.

Every entry point takes ``torch.Tensor`` inputs, requiring grad or not, as
it takes NumPy arrays: they are detached and read on the host where the
port works in NumPy.  The results equal those of the same values passed as
NumPy arrays, exactly.  ``logpdf`` returns a detached 0-d tensor in the
estimator's dtype on its device when ``x`` or ``y`` is a tensor (the JAX
package returns a device scalar for JAX inputs), and a Python float for
NumPy inputs; the value agrees with JAX's score of the same data to 1e-8.
A CUDA tensor takes the same path (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jnp, torch

from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

from gpar_torch import GPARRegressor as TReg  # noqa: E402

P, N, NT, S = 3, 30, 8, 4
MODELS = {"sparse": bench_kwargs(n_ind=6), "dense": dict(bench_kwargs(), x_ind=None)}


def _grad(a):
    return torch.tensor(a, dtype=torch.float64, requires_grad=True)


def _data():
    x, y, x_test = chain_data(n=N, p=P, seed=3, n_test=NT)
    y[:, 2][::7] = np.nan
    w = np.random.default_rng(2).uniform(0.5, 2.0, (N, P))
    return x, y, w, x_test


@pytest.mark.parametrize("model", list(MODELS))
def test_tensors_that_require_grad_serve_as_arrays(model):
    x, y, w, x_test = _data()
    kw = MODELS[model]
    arrays, tensors = TReg(**kw, device="cpu"), TReg(**dict(
        kw, x_ind=None if kw["x_ind"] is None else _grad(kw["x_ind"])), device="cpu")
    arrays.condition(x, y, w)
    tensors.condition(_grad(x), _grad(y), _grad(w))
    for a, b in ((arrays._x_np, tensors._x_np), (arrays._y_np, tensors._y_np),
                 (arrays._w_np, tensors._w_np), (arrays._means, tensors._means)):
        np.testing.assert_array_equal(a, b)
    normals = np.random.default_rng(1).standard_normal((P, S, NT))
    want = arrays.predict(x_test, num_samples=S, credible_bounds=True, normals=normals)
    got = tensors.predict(_grad(x_test), num_samples=S, credible_bounds=True, normals=_grad(normals))
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)
    got = tensors.sample(_grad(x_test), w=_grad(np.ones((NT, P))), posterior=True, num_samples=S,
                         normals=normals)
    want = arrays.sample(x_test, posterior=True, num_samples=S, normals=normals)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    for posterior in (False, True):
        for extra in ({}, {"sample_missing": True, "normals": [np.zeros(4)]}):
            want = arrays.logpdf(x, y, w, posterior=posterior, **extra)
            got = tensors.logpdf(_grad(x), _grad(y), _grad(w), posterior=posterior, **extra)
            assert isinstance(want, float)
            assert isinstance(got, torch.Tensor) and got.ndim == 0 and not got.requires_grad
            assert got.dtype == torch.float64 and got.device.type == "cpu"
            assert float(got) == want
    # One tensor input is enough for a tensor result.
    assert isinstance(arrays.logpdf(_grad(x), y), torch.Tensor)
    assert isinstance(arrays.logpdf(x, _grad(y)), torch.Tensor)


def test_fit_takes_tensors_and_scores_as_jax():
    x, y, w, _ = _data()
    kw = MODELS["sparse"]
    rt = TReg(**kw, device="cpu")
    rt.fit(_grad(x), _grad(y), iters=1)
    rj = JReg(**kw)
    rj.condition(x, y)
    rj._ensure_vars(P)
    rj.vs.restore(rt.vs.snapshot())
    got = rt.logpdf(_grad(x), _grad(y))
    want = rj.logpdf(jnp.asarray(x), jnp.asarray(y))
    assert isinstance(want, jax.Array) and want.ndim == 0  # the rule the port follows
    close(got, want, rtol=1e-8)
    ref = TReg(**kw, device="cpu")
    ref.fit(x, y, iters=1)
    for k, v in ref.vs.snapshot().items():
        np.testing.assert_array_equal(v, rt.vs.snapshot()[k])
