"""Checkpoints of gpar_torch against gpar_tpu's (``tests/test_checkpoint.py``,
``tests/test_greedy.py``'s order round trip), float64, on the CPU.

Both packages write the same pickle (``format_version`` 1, NumPy and
Python values only), so a file written by either loads in the other.  The
tests hold the crossing both ways: the latents and transforms, the
conditioned data, the normaliser statistics and the output order arrive
unchanged (bit for bit), and the prior and posterior scores and the
predictions from the same normals agree with the other package's to 1e-8.
A port-to-port round trip predicts the same bits.  A load starts with no
cached posterior factors.
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jax_chain_normals

import gpar_tpu  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402
from gpar_tpu.utils import checkpoint as jck  # noqa: E402

import gpar_torch  # noqa: E402
import gpar_torch.params.store as TS  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.utils import checkpoint as tck  # noqa: E402

P, N, NT, S = 3, 40, 10, 6
TOL = 1e-8
MODELS = {"sparse": bench_kwargs(n_ind=8), "dense": dict(bench_kwargs(), x_ind=None)}
ORDER = [2, 0, 1]


def _data():
    x, y, x_test = chain_data(n=N, p=P, seed=2, n_test=NT)
    y = np.exp(0.3 * y)  # positive, for the log transform
    y[:, 1:][np.random.default_rng(5).uniform(size=(N, P - 1)) < 0.1] = np.nan
    return x, y, x_test


@pytest.fixture(scope="module")
def latents():
    x, y, _ = _data()
    out = {}
    for name, kw in MODELS.items():
        rt = TReg(**kw, device="cpu")
        rt.fit(x, y, iters=2)
        out[name] = rt.vs.snapshot()
    return out


def _jax(latents, model, log=False):
    x, y, _ = _data()
    rj = JReg(**MODELS[model], **({"transform_y": gpar_tpu.log_transform} if log else {}))
    rj.condition(x, y)
    rj._ensure_vars(P)
    rj.vs.restore(latents[model])
    return rj


def _port(latents, model, order=None):
    x, y, _ = _data()
    rt = TReg(**MODELS[model], device="cpu")
    rt.condition(x, y)
    rt.load_latents(latents[model], order=order)
    return rt


def _same_state(rt, rj):
    """The port's estimator holds exactly the JAX estimator's state."""
    assert rt.model_config == rj.model_config
    assert (rt.replace, rt.impute, rt.normalise_y, rt.compat) == (
        rj.replace, rj.impute, rj.normalise_y, rj.compat)
    assert rt.vs.names == rj.vs.names
    for name in rj.vs.names:
        np.testing.assert_array_equal(rt.vs._latents[name].numpy(), np.asarray(rj.vs._latents[name]))
        assert jck._transform_state(rj.vs._transforms[name]) == tck._transform_state(
            rt.vs._transforms[name])
    for a, b in ((rt._x_np, rj._x_np), (rt._y_np, rj._y_np), (rt._w_np, rj._w_np),
                 (rt._means, rj._norm_stats["means"]), (rt._stds, rj._norm_stats["stds"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    if rj.x_ind is None:
        assert rt.x_ind is None
    else:
        np.testing.assert_array_equal(rt.x_ind.numpy(), np.asarray(rj.x_ind))
    assert (None if rt.order is None else list(rt.order)) == (
        None if rj.order is None else list(rj.order))
    assert (rt.n, rt.m, rt.p) == (rj.n, rj.m, rj.p)


def _serves_as(rt, rj):
    """Scores and predictions of the port agree with JAX's to 1e-8."""
    x, y, x_test = _data()
    for posterior in (False, True):
        close(rt.logpdf(x[:12], y[:12], posterior=posterior),
              rj.logpdf(x[:12], y[:12], posterior=posterior), rtol=TOL)
    key = jax.random.PRNGKey(3)
    want = rj.predict(x_test, num_samples=S, credible_bounds=True, key=key)
    got = rt.predict(x_test, num_samples=S, credible_bounds=True,
                     normals=jax_chain_normals(key, P, NT, num_samples=S))
    for a, b in zip(got, want):
        close(a, b, rtol=TOL, atol=1e-10)


@pytest.mark.parametrize("model", list(MODELS))
def test_jax_checkpoint_loads_in_the_port(latents, model, tmp_path):
    rj = _jax(latents, model)
    path = str(tmp_path / "jax.pkl")
    jck.save(rj, path)
    rt = tck.load(path, device="cpu")
    _same_state(rt, rj)
    assert rt._factor_cache is None
    _serves_as(rt, rj)


@pytest.mark.parametrize("model", list(MODELS))
def test_port_checkpoint_loads_in_jax(latents, model, tmp_path):
    # With a greedy-style output order, which the load rebinds.
    rt = _port(latents, model, order=ORDER)
    path = str(tmp_path / "port.pkl")
    tck.save(rt, path)
    rj = jck.load(path)
    _same_state(rt, rj)
    _serves_as(rt, rj)
    # And back: the JAX-written copy of the port's state loads as it was.
    jck.save(rj, path)
    _same_state(tck.load(path, device="cpu"), rj)


def test_transform_is_given_again_on_load(latents, tmp_path):
    rj = _jax(latents, "sparse", log=True)
    path = str(tmp_path / "log.pkl")
    jck.save(rj, path)
    rt = tck.load(path, transform_y=gpar_torch.log_transform, device="cpu")
    _same_state(rt, rj)
    _serves_as(rt, rj)


def test_port_round_trip_predicts_the_same_bits(latents, tmp_path):
    rt = _port(latents, "sparse", order=ORDER)
    x_test = _data()[2]
    normals = np.random.default_rng(8).standard_normal((P, S, NT))
    assert rt.precompute()
    want = rt.predict(x_test, num_samples=S, credible_bounds=True, normals=normals)
    path = str(tmp_path / "rt.pkl")
    tck.save(rt, path)
    back = tck.load(path, device="cpu")
    assert back._factor_cache is None and back.vs.names == rt.vs.names
    got = back.predict(x_test, num_samples=S, credible_bounds=True, normals=normals)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert back._factor_cache is not None  # the load's first predict fills the slot


def test_unconditioned_state_round_trips(tmp_path):
    # ``tests/test_checkpoint.py``'s first case, across the packages.
    x = np.random.default_rng(11).normal(size=(10, 2))
    rt = TReg(scale=0.5, nonlinear=True, markov=1, noise=0.05, device="cpu")
    rt.sample(x, p=2, normals=np.zeros((2, 1, 10)))  # instantiates the variables
    path = str(tmp_path / "prior.pkl")
    tck.save(rt, path)
    rj = jck.load(path)
    assert rj.model_config == rt.model_config and rj.vs.names == rt.vs.names
    assert not rj.is_conditioned
    back = tck.load(path, device="cpu")
    assert not back.is_conditioned and back._means is None
    for name in rt.vs.names:
        np.testing.assert_array_equal(back.vs._latents[name].numpy(), rt.vs._latents[name].numpy())
        np.testing.assert_array_equal(np.asarray(rj.vs._latents[name]), rt.vs._latents[name].numpy())
        close(back.vs[name], rt.vs[name], rtol=0)


def test_unknown_transform_state_raises():
    with pytest.raises(ValueError, match="Unknown transform state"):
        tck._transform_from_state(("log",))
    with pytest.raises(TypeError, match="Unknown transform"):
        tck._transform_state(object())
    assert isinstance(tck._transform_from_state(("bounded", 1e-3, 1e3)), TS._Bounded)
