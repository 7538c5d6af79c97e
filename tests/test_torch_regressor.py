"""The gpar_torch slice as a whole against gpar_tpu: the benchmark's
configuration scaled down (p=3, n=100, 8 inducing points, float64).

- ``fit(iters=5)`` against the JAX per-layer loop
  (``fit(fused=False, iters=5)``): per-layer NLLs to 1e-6 relative, every
  latent to 1e-6 / 1e-8 (both run the same L-BFGS on the same objective;
  the port feeds fixed layers forward once instead of re-conditioning
  them per layer, which changes summation order only).
- ``predict`` at the JAX package's fitted latents with the JAX package's
  own standard normals against a NumPy mean / percentile reduction of the
  JAX sampling chain: 1e-8.
- ``fit_predict`` equals ``fit`` followed by ``predict``.
Plus the package's surface: import hygiene and the device default.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, close, jax, jax_chain_normals, np_, torch

import gpar_tpu  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.params.store import Vars as TVars  # noqa: E402

P, S, ITERS = 3, 8, 5
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def runs():
    x, y, x_test = chain_data(n=100, p=P, seed=0, n_test=20)
    kw = bench_kwargs(n_ind=8)
    rj = JReg(**kw)
    rj.fit(x, y, iters=ITERS, fused=False)
    key = jax.random.PRNGKey(5)
    prev = gpar_tpu.config.scan_predict
    gpar_tpu.config.scan_predict = False  # the unrolled per-sample chain
    try:
        samples = rj.sample(x_test, posterior=True, num_samples=S, key=key)
    finally:
        gpar_tpu.config.scan_predict = prev
    rt = TReg(**kw, device="cpu")
    rt.fit(x, y, iters=ITERS)
    return dict(
        x=x, y=y, x_test=x_test, kw=kw, rj=rj, rt=rt,
        batch=np.stack(samples), normals=jax_chain_normals(key, P, len(x_test), num_samples=S),
    )


def test_fit_matches_jax_per_layer_loop(runs):
    rj, rt = runs["rj"], runs["rt"]
    rep = rt.last_fit_report
    close(rep["layer_nll"], rj.last_fit_report["layer_nll"], rtol=1e-6)
    assert np.all(rep["layer_nll0"] > rep["layer_nll"])
    assert rep["layer_iters"].tolist() == [ITERS] * P
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    assert list(sj) == list(st)
    for k in sj:
        close(st[k], sj[k], rtol=1e-6, atol=1e-8)
    assert rt.get_variables().keys() == rj.get_variables().keys()


def test_predict_with_jax_normals_matches_jax_chain(runs):
    rt = TReg(**runs["kw"], device="cpu")
    rt.condition(runs["x"], runs["y"])
    rt.load_latents(runs["rj"].vs.snapshot())
    mean, lo, hi = rt.predict(runs["x_test"], num_samples=S, credible_bounds=True,
                              normals=runs["normals"])
    batch = runs["batch"]
    assert mean.shape == (len(runs["x_test"]), P)
    close(mean, batch.mean(axis=0), rtol=1e-8, atol=1e-10)
    close(lo, np.percentile(batch, 2.5, axis=0), rtol=1e-8, atol=1e-10)
    close(hi, np.percentile(batch, 97.5, axis=0), rtol=1e-8, atol=1e-10)
    only_mean = rt.predict(runs["x_test"], num_samples=S, normals=runs["normals"])
    close(only_mean, mean, rtol=0)


def test_fit_predict_equals_fit_then_predict(runs):
    rt = TReg(**runs["kw"], device="cpu")
    got = rt.fit_predict(runs["x"], runs["y"], runs["x_test"], iters=ITERS, num_samples=S,
                         credible_bounds=True, normals=runs["normals"])
    want = runs["rt"].predict(runs["x_test"], num_samples=S, credible_bounds=True,
                              normals=runs["normals"])
    for a, b in zip(got, want):
        close(a, b, rtol=1e-12)
    close(rt.last_fit_report["layer_nll"], runs["rt"].last_fit_report["layer_nll"], rtol=1e-12)


def test_generator_draws_are_reproducible(runs):
    rt, xt = runs["rt"], runs["x_test"]
    a = rt.predict(xt, num_samples=4, generator=torch.Generator().manual_seed(1))
    b = rt.predict(xt, num_samples=4, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a, b)
    gpar_torch.set_seed(3)
    c = rt.predict(xt, num_samples=4)
    gpar_torch.set_seed(3)
    np.testing.assert_array_equal(c, rt.predict(xt, num_samples=4))
    with pytest.raises(ValueError, match="normals"):
        rt.predict(xt, num_samples=4, normals=np.zeros((P, 3, len(xt))))


def test_condition_normalisation_matches_jax():
    # NaN-aware per-output statistics with the std == 0 -> 1 guard.
    x, y, _ = chain_data(n=30, p=3, seed=2)
    y[[1, 4, 9], 1] = np.nan
    y[:, 2] = 1.5
    kw = bench_kwargs(n_ind=5)
    rj, rt = JReg(**kw), TReg(**kw, device="cpu")
    rj.condition(x, y)
    rt.condition(x, y)
    close(rt._y_np, rj._y_np, rtol=1e-15)
    close(rt._stds, rj._norm_stats["stds"], rtol=1e-15)
    close(rt._means, rj._norm_stats["means"], rtol=1e-15)
    close(rt.x, rj.x, rtol=0)


def test_unported_options_raise(runs):
    # Restarts, greedy ordering and fused="unroll" are ported
    # (tests/test_torch_restarts.py, tests/test_torch_greedy.py,
    # tests/test_torch_unroll.py); under compat=True, the default, greedy
    # raises as the reference does.  The unrolled fit is the computation of
    # the JAX package's per-layer loop (the fixture's), reported as "unroll".
    rt = TReg(**runs["kw"], device="cpu")
    rt.fit(runs["x"], runs["y"], iters=ITERS, fused="unroll")
    assert rt.last_fit_report["fused"] == "unroll"
    close(rt.last_fit_report["layer_nll"], runs["rj"].last_fit_report["layer_nll"], rtol=1e-6)
    with pytest.raises(NotImplementedError):
        rt.fit(runs["x"], runs["y"], greedy=True)
    with pytest.raises(ValueError, match="restarts"):
        rt.fit(runs["x"], runs["y"], restarts=0)
    with pytest.raises(RuntimeError, match="condition"):
        TReg(**runs["kw"], device="cpu").load_latents({})


def test_device_default_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TReg()
    with pytest.raises(RuntimeError, match="CUDA"):
        TReg(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TVars()
    assert TReg(device="cpu").device == torch.device("cpu")
    assert TVars(device="cpu").device == torch.device("cpu")


def test_import_pulls_in_neither_jax_nor_gpar_tpu():
    code = (
        "import sys, gpar_torch, gpar_torch.ops.gram_kernel, gpar_torch.ops._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'gpar_tpu'))]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_never_import_jax_or_gpar_tpu():
    # Docstrings may name their JAX counterpart's file; no code may load it.
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|gpar_tpu)\b|import_module\(\s*['\"](jax|gpar_tpu)",
        re.MULTILINE,
    )
    files = sorted((REPO / "gpar_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py", REPO / "tests" / "torch_cases.py",
    ]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
