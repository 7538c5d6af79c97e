"""``GPARRegressor.warmup`` of gpar_torch against gpar_tpu's
(``tests/test_buckets.py``'s warmup tests), on the CPU.

Where the two packages' warmups are compared, the scratch estimator's
entry points are replaced by recorders in both, so that the calls, their
arguments and the synthetic data are compared exactly (the data bit for
bit; through a log transform to 1e-14, ``torch.exp`` against
``jnp.exp``) without running JAX's programs.  One real warmup of the port
runs at a small size.  The graphs a warmup captures on the card are
checked in ``tests/test_torch_cuda.py``.

Differences by design, each pinned here: the port always buckets rows, so
there is no ``config.shape_buckets`` and no error for it; its tails run at
the caller's sample count, so ``buckets`` has no ``"samples"``.
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data

import gpar_tpu  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.config import bucket_rows  # noqa: E402

KW = dict(bench_kwargs(n_ind=8), replace=True)
ENTRY_POINTS = ("condition", "fit", "logpdf", "predict", "fit_predict")


def _recorded(monkeypatch, cls):
    """Replace the entry points of ``cls`` by recorders; returns the list
    of ``(name, args, kwargs)`` they receive, arrays as NumPy."""
    calls = []

    def recorder(name):
        def call(self, *args, **kwargs):
            calls.append((name, [np.asarray(a) if a is not None else None for a in args],
                          {k: (np.asarray(v) if k == "x_test" else v) for k, v in kwargs.items()}))

        return call

    for name in ENTRY_POINTS:
        monkeypatch.setattr(cls, name, recorder(name))
    return calls


@pytest.mark.parametrize("n_test", [None, 20])
@pytest.mark.parametrize("transform", ["identity", "log"])
def test_warmup_drives_the_entry_points_as_jax_does(monkeypatch, n_test, transform):
    tr = {"identity": {}, "log": {"t": gpar_torch.log_transform, "j": gpar_tpu.log_transform}}[transform]
    rt = TReg(**KW, device="cpu", **({"transform_y": tr["t"]} if tr else {}))
    rj = JReg(**KW, **({"transform_y": tr["j"]} if tr else {}))
    got_calls, want_calls = _recorded(monkeypatch, TReg), _recorded(monkeypatch, JReg)
    opts = dict(iters=3, gtol=1e-7, restarts=2)
    got = rt.warmup(50, 3, m=2, n_test=n_test, num_samples=7, **opts)
    want = rj.warmup(50, 3, m=2, n_test=n_test, num_samples=7, **opts)
    assert got["buckets"]["rows"] == want["buckets"]["rows"] == bucket_rows(50)
    if n_test is not None:
        assert got["buckets"]["test_rows"] == want["buckets"]["test_rows"] == bucket_rows(n_test)
        assert "samples" in want["buckets"] and "samples" not in got["buckets"]  # by design
    assert set(got["seconds"]) == set(want["seconds"])
    assert [c[0] for c in got_calls] == [c[0] for c in want_calls]
    rtol = 0 if transform == "identity" else 1e-14
    for (name, a_t, k_t), (_, a_j, k_j) in zip(got_calls, want_calls):
        assert len(a_t) == len(a_j), name
        for u, v in zip(a_t, a_j):
            assert u.shape == v.shape and u.dtype == v.dtype == np.float64, name
            np.testing.assert_allclose(u, v, rtol=rtol, atol=0)
        assert sorted(k_t) == sorted(k_j), name
        for k in k_t:
            if k == "x_test":
                np.testing.assert_array_equal(k_t[k], k_j[k])
            else:
                assert k_t[k] == k_j[k], (name, k)


def test_warmup_argument_errors_are_jax_s():
    for cls, kw in ((TReg, dict(device="cpu")), (JReg, {})):
        reg = cls(noise=0.1, **kw)
        with pytest.raises(ValueError, match="greedy"):
            reg.warmup(10, 2, greedy=True)
        with pytest.raises(ValueError, match="n_test"):
            reg.warmup(10, 2, paths=("predict",))
        with pytest.raises(ValueError, match="n_test"):
            reg.warmup(10, 2, paths=("fit_predict",))
        with pytest.raises(ValueError, match="paths"):
            reg.warmup(10, 2, paths=("serve",))
    # No shape_buckets switch to refuse (JAX raises RuntimeError when it is
    # off): the port always buckets rows.
    assert hasattr(gpar_tpu.config, "shape_buckets")
    assert not hasattr(gpar_torch.config, "shape_buckets")


def test_warmup_runs_and_leaves_the_estimator_untouched():
    x, y, x_test = chain_data(n=30, p=2, seed=1, n_test=9)
    reg = TReg(**KW, device="cpu")
    rep = reg.warmup(40, 2, n_test=20, num_samples=5, iters=2)
    assert set(rep["seconds"]) == {"fit", "predict", "fit_predict", "logpdf"}
    assert rep["buckets"] == {"rows": bucket_rows(40), "test_rows": bucket_rows(20)}
    assert not reg.is_conditioned and reg.vs.names == []
    # A conditioned, fitted estimator keeps its data, latents and factors.
    reg.fit(x, y, iters=1)
    assert reg.precompute()
    snap, slot, data = reg.vs.snapshot(), reg._factor_cache, (reg._x_np, reg._y_np, reg._w_np)
    report = reg.last_fit_report
    reg.warmup(40, 2, iters=2)
    assert reg._factor_cache is slot and reg.last_fit_report is report
    assert all(a is b for a, b in zip((reg._x_np, reg._y_np, reg._w_np), data))
    for k, v in reg.vs.snapshot().items():
        np.testing.assert_array_equal(v, snap[k])
    mean = reg.predict(x_test, num_samples=4, normals=np.zeros((2, 4, 9)))
    assert mean.shape == (9, 2) and np.isfinite(mean).all()
