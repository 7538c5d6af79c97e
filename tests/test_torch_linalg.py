"""gpar_torch.ops.linalg against gpar_tpu.ops.linalg.

Float64 results agree to 1e-10 relative: both packages run the same
algorithm and differ only in LAPACK call order and summation order.  The
float32 pins of the JAX package's own suite are carried over unchanged.
"""

import numpy as np
import pytest

from .test_torch_common import close, jax, jnp, np_, torch

import gpar_tpu.ops.linalg as JL  # noqa: E402
from gpar_tpu.config import config as jconfig  # noqa: E402

import gpar_torch.ops.linalg as TL  # noqa: E402
from gpar_torch.config import config as tconfig  # noqa: E402
from gpar_torch.ops.kernels import EQ, gram, kdiag  # noqa: E402

rng = np.random.default_rng(21)


def _eq_gram(a, b, ls=1.3, var=1.1):
    d2 = (a[:, None] - b[None, :]) ** 2
    return var * np.exp(-0.5 * d2 / ls**2)


def _titsias_problem(n=60, m=7, seed=0):
    r = np.random.default_rng(seed)
    x = np.sort(r.uniform(0, 10, n))
    z = np.linspace(0, 10, m)
    y = np.sin(x) + 0.1 * r.standard_normal(n)
    mean = 0.05 * r.standard_normal(n)
    noise = r.uniform(0.01, 0.05, n)
    mask = (r.uniform(size=n) > 0.2).astype(float)
    return _eq_gram(z, z), _eq_gram(z, x), np.full(n, 1.1), y, mean, noise, mask


def _both(fn_j, fn_t, *arrays, **kw):
    return fn_j(*[jnp.asarray(a) for a in arrays], **kw), fn_t(
        *[torch.as_tensor(a) for a in arrays], **kw
    )


@pytest.mark.parametrize("masked", [False, True])
def test_titsias_factors_match_jax(masked):
    Kmm, Kmn, knn, y, mean, noise, mask = _titsias_problem()
    args = (Kmm, Kmn, knn, y, mean, noise)
    if masked:
        j = JL.titsias_factors(*[jnp.asarray(a) for a in args], mask=jnp.asarray(mask))
        t = TL.titsias_factors(*[torch.as_tensor(a) for a in args], mask=torch.as_tensor(mask))
    else:
        j, t = _both(JL.titsias_factors, TL.titsias_factors, *args)
    for a, b in zip(t, j):
        close(a, b, rtol=1e-10, atol=1e-12)
    elbo_j, elbo_t = _both(JL.titsias_elbo, TL.titsias_elbo, *args)
    close(elbo_t, elbo_j, rtol=1e-10)


def _indefinite(n, neg, level):
    A = rng.normal(size=(n, n))
    w, V = np.linalg.eigh((A + A.T) / 2)
    w = np.abs(w) + 0.1
    w[:neg] = -level
    return V @ np.diag(w) @ V.T


@pytest.mark.parametrize(
    "level,jitter",
    [(0.5e-9, 1e-9), (0.5e-6, 1e-6), (2e-6, None)],
    ids=["second-rung", "third-rung", "relative-rung"],
)
def test_safe_cholesky_retry_ladder_matches_jax(level, jitter):
    K = _indefinite(12, 2, level)
    assert np.linalg.eigvalsh(K).min() < 0  # fails the first rung
    Lj, Lt = _both(JL.safe_cholesky, TL.safe_cholesky, K)
    Lj, Lt = np_(Lj), np_(Lt)
    assert np.isfinite(Lt).all()
    # The same rung in both: L L^T = K + jitter I.
    jt, jj = np.diag(Lt @ Lt.T - K), np.diag(Lj @ Lj.T - K)
    close(jt, jj, rtol=1e-6)
    if jitter is not None:
        close(jt, np.full(12, jitter), rtol=1e-6)
    else:
        assert jt.min() > 1e-6  # beyond the absolute rungs
    close(Lt @ Lt.T, Lj @ Lj.T, rtol=1e-12, atol=1e-13)
    # K + jitter I has condition ~1 / jitter, so the factor's entries agree
    # to ~eps / jitter absolute (entries are O(1)), not to 1e-10 relative.
    close(Lt, Lj, rtol=0, atol=1e-10)
    # The gradient is that of the rung that succeeded, in both packages.
    R = rng.normal(size=K.shape)
    gj = jax.grad(lambda k: jnp.sum(JL.safe_cholesky(k) * jnp.asarray(R)))(jnp.asarray(K))
    Kt = torch.as_tensor(K).requires_grad_(True)
    (gt,) = torch.autograd.grad(torch.sum(TL.safe_cholesky(Kt) * torch.as_tensor(R)), Kt)
    assert np.isfinite(np_(gt)).all()
    # JAX's Cholesky VJP symmetrises its cotangent; compare symmetric parts,
    # at the same conditioning-limited accuracy relative to the largest entry.
    gts, gjs = np_(gt), np_(gj)
    gts, gjs = 0.5 * (gts + gts.T), 0.5 * (gjs + gjs.T)
    close(gts, gjs, rtol=0, atol=1e-6 * np.abs(gjs).max())


def test_mvn_logpdf_and_solves_match_jax():
    A = rng.normal(size=(9, 9))
    K = A @ A.T + 0.5 * np.eye(9)
    y, mean = rng.normal(size=9), rng.normal(size=9)
    Lj, Lt = _both(JL.safe_cholesky, TL.safe_cholesky, K)
    close(Lt, Lj, rtol=1e-10)
    close(TL.mvn_logpdf_chol(torch.as_tensor(y), torch.as_tensor(mean), Lt),
          JL.mvn_logpdf_chol(jnp.asarray(y), jnp.asarray(mean), Lj), rtol=1e-10)
    close(TL.mvn_logpdf(torch.as_tensor(y), torch.as_tensor(mean), torch.as_tensor(K)),
          JL.mvn_logpdf(jnp.asarray(y), jnp.asarray(mean), jnp.asarray(K)), rtol=1e-10)
    B = rng.normal(size=(9, 4))
    close(TL.solve_chol(Lt, torch.as_tensor(B)), JL.solve_chol(Lj, jnp.asarray(B)), rtol=1e-10)
    close(TL.solve_lower(Lt, torch.as_tensor(y)), JL.solve_lower(Lj, jnp.asarray(y)), rtol=1e-10)
    close(TL.add_jitter(torch.as_tensor(K)), JL.add_jitter(jnp.asarray(K)), rtol=1e-15)


def test_jitter_policy_matches_jax():
    for dt_j, dt_t in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        assert TL.resolve_epsilon(dt_t) == JL.resolve_epsilon(dt_j)
    noise = np.array([1e-9, 1e-7, 1e-3])
    close(TL.floor_noise(torch.as_tensor(noise, dtype=torch.float32)),
          JL.floor_noise(jnp.asarray(noise, jnp.float32)), rtol=0)
    close(TL.floor_noise(torch.as_tensor(noise)), JL.floor_noise(jnp.asarray(noise)), rtol=0)
    assert tconfig.cholesky_retry_factors == jconfig.cholesky_retry_factors
    assert (tconfig.epsilon, tconfig.epsilon_f32) == (jconfig.epsilon, jconfig.epsilon_f32)


def test_psd_sample_factor_clamps_indefinite_like_jax():
    # Indefinite beyond every jitter rung: both clamp the spectrum.  The
    # eigenvector signs are arbitrary, so compare F F^T, not F.
    K = _indefinite(10, 3, 1e-2)
    Fj, Ft = _both(JL.psd_sample_factor, TL.psd_sample_factor, K)
    Ft, Fj = np_(Ft), np_(Fj)
    assert np.isfinite(Ft).all()
    close(Ft @ Ft.T, Fj @ Fj.T, rtol=1e-10, atol=1e-12)
    # A well-conditioned matrix gets its Cholesky factor.
    A = rng.normal(size=(6, 6))
    K = A @ A.T + np.eye(6)
    Fj, Ft = _both(JL.psd_sample_factor, TL.psd_sample_factor, K)
    close(Ft, Fj, rtol=1e-10)


def test_titsias_f32_elbo_accurate_at_noise_floor():
    # The JAX suite's pin (tests/test_linalg.py), on the port: at the
    # float32 noise floor the cancellation-free ELBO stays within 10% of
    # float64 and hugely negative, not sign-flipped garbage.
    n, m = 2048, 128
    r = np.random.default_rng(7)
    x64 = np.sort(r.uniform(0, 10, n))[:, None]
    z64 = np.linspace(0, 10, m)[:, None]
    y64 = np.sin(x64[:, 0]) + 0.05 * r.standard_normal(n)

    def elbo(dtype):
        x = torch.as_tensor(x64, dtype=dtype)
        z = torch.as_tensor(z64, dtype=dtype)
        y = torch.as_tensor(y64, dtype=dtype)
        k = EQ().stretch(torch.tensor([1.0], dtype=dtype))
        noise = torch.full((n,), 1e-6, dtype=dtype)
        e, _, _, beta = TL.titsias_factors(
            gram(k, z, z), gram(k, z, x), kdiag(k, x), y, torch.zeros_like(y), noise
        )
        return float(e), np_(beta)

    e64, _ = elbo(torch.float64)
    e32, beta32 = elbo(torch.float32)
    assert np.isfinite(e32)
    assert e64 < -1e5
    assert abs(e32 - e64) < 0.10 * abs(e64), (e32, e64)
    assert np.all(np.isfinite(beta32))


def test_titsias_trace_clamp_blocks_f32_variance_blowup():
    # The JAX suite's pin: with the Nystrom-residual clamp, enormous prior
    # variance is enormously unlikely in float32, never favourable.
    n, m = 256, 16
    r = np.random.default_rng(3)
    x = torch.as_tensor(r.uniform(0, 10, (n, 1)), dtype=torch.float32)
    z = torch.as_tensor(np.linspace(0, 10, m)[:, None], dtype=torch.float32)
    y = torch.sin(x[:, 0])
    noise = torch.full((n,), 2.5e-4, dtype=torch.float32)
    for v in [1e12, 1e20, 1e29]:
        k = torch.tensor(v, dtype=torch.float32) * EQ().stretch(torch.tensor([1.0]))
        elbo, *_ = TL.titsias_factors(
            gram(k, z, z), gram(k, z, x), kdiag(k, x), y, torch.zeros_like(y), noise
        )
        assert float(elbo) < -1e4, (v, float(elbo))

    x64 = torch.as_tensor(r.uniform(0, 10, (64, 1)))
    z64 = torch.as_tensor(np.linspace(0, 10, 8)[:, None])
    y64 = torch.sin(x64[:, 0])
    k64 = 1.3 * EQ().stretch(torch.tensor([0.9], dtype=torch.float64))
    e1, *_ = TL.titsias_factors(
        gram(k64, z64, z64), gram(k64, z64, x64), kdiag(k64, x64),
        y64, torch.zeros_like(y64), torch.full((64,), 0.01, dtype=torch.float64),
    )
    assert np.isfinite(float(e1))


def test_the_jitter_rule_lives_in_ops_linalg_alone():
    # One module decides which rung a factorisation takes: no other module
    # of the port imports or reads a private name of ops.linalg, only
    # ops.linalg reads the retry factors (config.py sets them), and the
    # optimiser knows nothing of rungs, jitter or Cholesky factors.
    import ast
    import pathlib
    import re

    root = pathlib.Path(TL.__file__).resolve().parents[1]
    linalg, cfg = root / "ops" / "linalg.py", root / "config.py"
    private, retry = [], []
    for path in sorted(root.rglob("*.py")):
        if path == linalg:
            continue
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("linalg"):
                private += [(path.name, a.name) for a in node.names if a.name.startswith("_")]
            if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                    and node.value.id == "linalg" and node.attr.startswith("_")):
                private.append((path.name, node.attr))
        if path != cfg and "cholesky_retry_factors" in text:
            retry.append(path.name)
    assert private == [] and retry == []
    params = {p.name: re.findall(r"(?i)rung|jitter|cholesky", p.read_text())
              for p in sorted((root / "params").glob("*.py"))}
    assert params and not any(params.values()), params
