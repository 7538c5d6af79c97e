"""gpar_torch.parallel against the JAX package, float64 on the CPU.

Every comparison runs the port on a virtual CPU mesh (``make_mesh(8,
devices=[torch.device("cpu")] * 8)``, or 4 shards) and the JAX package on
one device, from the same seeded NumPy inputs:

- ``make_mesh``: its size, its ``ValueError`` with too few devices, and the
  ``NotImplementedError`` in one rank of a multi-process
  ``torch.distributed`` group (``make_mesh`` and ``use_mesh``);
  ``use_mesh`` restores the configuration; ``pad_rows`` against JAX's.
- ``sharded_titsias_elbo`` / ``sharded_titsias_factors`` against JAX's
  one-device ``titsias_elbo`` and ``PseudoObs`` factors, n = 43 on 8 shards
  (padded rows), 1e-8; their gradient against ``jax.grad`` of JAX's ELBO,
  1e-8.
- ``sharded_dense_factors`` (the distributed blocked Cholesky): logpdf,
  ``L`` and ``alpha`` against JAX's one-device dense ``Obs``, 1e-8, at
  n = 43 on 8 shards and n = 130 on 4 (two panels per shard); the gradient
  through its ``autograd.Function`` against ``jax.grad``, 1e-7; the
  gradient of ``alpha`` against autograd of the one-device solve, 1e-8;
  and one direct comparison with JAX's own ``sharded_dense_factors`` on a
  4-device CPU mesh at n = 40, 1e-8.
- The GP core under ``use_mesh``: ``Obs`` and ``PseudoObs`` of a zero-mean
  prior take the sharded branches and equal JAX's one-device values, 1e-8.
- ``sharded_sample_batch``: the split draws equal the unsplit ones.
"""

import numpy as np
import pytest

from .test_torch_common import close, jax, jnp, np_, torch

import gpar_tpu.ops.kernels as JK  # noqa: E402
from gpar_tpu.gp import GP as JGP  # noqa: E402
from gpar_tpu.gp.core import Obs as JObs  # noqa: E402
from gpar_tpu.gp.core import PseudoObs as JPseudoObs  # noqa: E402
from gpar_tpu.ops.linalg import titsias_elbo as j_titsias_elbo  # noqa: E402
from gpar_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from gpar_tpu.parallel import pad_rows as j_pad_rows  # noqa: E402
from gpar_tpu.parallel import sharded_dense_factors as j_sharded_dense_factors  # noqa: E402

import gpar_torch  # noqa: E402
import gpar_torch.ops.kernels as TK  # noqa: E402
from gpar_torch.config import config as tconfig  # noqa: E402
from gpar_torch.config import mesh_descriptor  # noqa: E402
from gpar_torch.gp import GP as TGP  # noqa: E402
from gpar_torch.gp.core import Obs as TObs  # noqa: E402
from gpar_torch.gp.core import PseudoObs as TPseudoObs  # noqa: E402
from gpar_torch.ops.linalg import safe_cholesky, solve_chol  # noqa: E402
from gpar_torch.parallel import (  # noqa: E402
    Mesh,
    make_mesh,
    pad_rows,
    sharded_dense_factors,
    sharded_dense_logpdf,
    sharded_sample_batch,
    sharded_titsias_elbo,
    sharded_titsias_factors,
    titsias_psum_body,
)

CPU = torch.device("cpu")
VAR, SCALES = 1.3, (0.9, 1.4)


def cpu_mesh(n=8):
    return make_mesh(n, devices=[CPU] * n)


def _problem(n, seed, m=6):
    r = np.random.default_rng(seed)
    return dict(x=r.normal(size=(n, 2)), z=r.normal(size=(m, 2)), y=r.normal(size=n),
                noise=r.uniform(0.05, 0.2, size=n))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), requires_grad=grad)


def _kernels(var, scales):
    """The same tree in both packages: ``var * EQ().stretch(scales)``."""
    if isinstance(var, torch.Tensor):
        return var * TK.EQ().stretch(scales)
    return var * JK.EQ().stretch(scales)


# The JAX references are jitted: one compile each instead of one per op.
@jax.jit
def _jax_elbo(var, scales, d):
    k = _kernels(var, scales)
    return j_titsias_elbo(JK.gram(k, d["z"], d["z"]), JK.gram(k, d["z"], d["x"]),
                          JK.kdiag(k, d["x"]), d["y"], jnp.zeros_like(d["y"]), d["noise"])


@jax.jit
def _jax_dense_logpdf(var, scales, d):
    return JObs(JGP(_kernels(var, scales))(d["x"], d["noise"]), d["y"]).logpdf


@jax.jit
def _jax_obs(var, scales, d):
    """JAX's one-device dense ``Obs`` and ``PseudoObs``: ``(logpdf, L,
    posterior mean at x)`` and ``(elbo, Lm, LB, beta)``."""
    f = JGP(_kernels(var, scales))
    dense = JObs(f(d["x"], d["noise"]), d["y"])
    sparse = JPseudoObs(f(d["z"]), f(d["x"], d["noise"]), d["y"])
    return ((dense.logpdf, dense.L, (f | dense).mean(d["x"])),
            (sparse.elbo, sparse.Lm, sparse.LB, sparse.beta))


def _jd(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


J_ARGS = (jnp.asarray(VAR), jnp.asarray(SCALES))


def test_make_mesh_size_and_errors():
    mesh = cpu_mesh(8)
    assert isinstance(mesh, Mesh) and mesh.size == 8 and mesh.virtual
    assert mesh.axis_names == ("dp",) and mesh.home == CPU
    assert make_mesh(3, axis="rows", devices=[CPU] * 8).devices == (CPU,) * 3
    with pytest.raises(ValueError, match=r"make_mesh\(9\) with only 8 device"):
        make_mesh(9, devices=[CPU] * 8)


def test_mesh_guard_in_a_multi_process_group(monkeypatch):
    # One rank of several cannot drive every shard: JAX's process_count() > 1
    # guard, read from torch.distributed.
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        make_mesh(2, devices=[CPU] * 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        with gpar_torch.use_mesh(Mesh((CPU,) * 2)):
            pass


def test_use_mesh_restores_config():
    prev = (tconfig.mesh, tconfig.shard_min_rows, tconfig.shard_axis)
    mesh = cpu_mesh(4)
    assert mesh_descriptor() is None
    with pytest.raises(RuntimeError):
        with gpar_torch.use_mesh(mesh, min_rows=8, axis="rows") as m:
            assert m is mesh and tconfig.mesh is mesh
            assert (tconfig.shard_min_rows, tconfig.shard_axis) == (8, "rows")
            desc = mesh_descriptor()
            assert desc[:3] == (("dp",), 4, ("cpu",) * 4) and desc[3:5] == ("rows", 8)
            raise RuntimeError
    assert (tconfig.mesh, tconfig.shard_min_rows, tconfig.shard_axis) == prev


@pytest.mark.parametrize("n,multiple", [(43, 8), (40, 8), (5, 4)])
def test_pad_rows_matches_jax(n, multiple):
    a = np.random.default_rng(n).normal(size=(n, 3))
    got, got_mask = pad_rows(_t(a), multiple, value=2.0)
    want, want_mask = j_pad_rows(jnp.asarray(a), multiple, value=2.0)
    close(got, want, rtol=0)
    close(got_mask, want_mask, rtol=0)


def test_sharded_titsias_matches_jax():
    d = _problem(43, 0)  # 43 rows on 8 shards: 5 padded rows
    mesh = cpu_mesh(8)
    x, mask = pad_rows(_t(d["x"]), 8)
    y, _ = pad_rows(_t(d["y"]), 8)
    noise, _ = pad_rows(_t(d["noise"]), 8, value=1.0)
    k = _kernels(_t(VAR), _t(SCALES))
    z = _t(d["z"])
    got = sharded_titsias_factors(k, z, x, y, noise, mask, mesh)
    for a, b in zip(got, _jax_obs(*J_ARGS, _jd(d))[1]):
        close(a, b, rtol=1e-8, atol=1e-12)
    close(sharded_titsias_elbo(k, z, x, y, noise, mask, mesh), _jax_elbo(*J_ARGS, _jd(d)),
          rtol=1e-8)


def test_sharded_titsias_grad_matches_jax():
    d = _problem(43, 1)
    mesh = cpu_mesh(8)
    x, mask = pad_rows(_t(d["x"]), 8)
    y, _ = pad_rows(_t(d["y"]), 8)
    noise, _ = pad_rows(_t(d["noise"]), 8, value=1.0)
    var, scales = _t(VAR, grad=True), _t(SCALES, grad=True)
    elbo = sharded_titsias_elbo(_kernels(var, scales), _t(d["z"]), x, y, noise, mask, mesh)
    g_var, g_scales = torch.autograd.grad(elbo, (var, scales))
    w_var, w_scales = jax.jit(jax.grad(_jax_elbo, argnums=(0, 1)))(*J_ARGS, _jd(d))
    close(g_var, w_var, rtol=1e-8)
    close(g_scales, w_scales, rtol=1e-8)


def test_titsias_psum_body_equals_one_shard():
    # Splitting the rows over shards changes only the order of the sums.
    d = _problem(40, 2)
    k = _kernels(_t(VAR), _t(SCALES))
    x, z = _t(d["x"]), _t(d["z"])
    Lm = safe_cholesky(TK.gram(k, z, z))
    A0 = torch.linalg.solve_triangular(Lm, TK.gram(k, z, x), upper=False)
    args = (TK.kdiag(k, x), _t(d["y"]), _t(d["noise"]), torch.ones(40, dtype=torch.float64))
    one = titsias_psum_body(Lm, [A0], *[[a] for a in args])
    four = titsias_psum_body(Lm, list(A0.chunk(4, dim=1)), *[list(a.chunk(4)) for a in args])
    for a, b in zip(one, four):
        close(a, b, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("n,shards", [(43, 8), (130, 4)])
def test_sharded_dense_factors_match_jax_obs(n, shards):
    d = _problem(n, 3)
    mesh = cpu_mesh(shards)
    var, scales = _t(VAR, grad=True), _t(SCALES, grad=True)
    logpdf, L, alpha = sharded_dense_factors(_kernels(var, scales), _t(d["x"]), _t(d["y"]),
                                             _t(d["noise"]), mesh)
    w_logpdf, w_L, _ = _jax_obs(*J_ARGS, _jd(d))[0]
    close(logpdf, w_logpdf, rtol=1e-8)
    close(L, w_L, rtol=1e-8, atol=1e-12)
    w_L = np_(w_L)
    close(alpha, np.linalg.solve(w_L @ w_L.T, d["y"]), rtol=1e-8, atol=1e-10)
    assert not L.requires_grad
    g_var, g_scales = torch.autograd.grad(logpdf, (var, scales))
    w_var, w_scales = jax.jit(jax.grad(_jax_dense_logpdf, argnums=(0, 1)))(*J_ARGS, _jd(d))
    close(g_var, w_var, rtol=1e-7)
    close(g_scales, w_scales, rtol=1e-7)
    close(sharded_dense_logpdf(_kernels(var, scales), _t(d["x"]), _t(d["y"]), _t(d["noise"]), mesh),
          w_logpdf, rtol=1e-8)


def test_sharded_dense_alpha_gradient_matches_one_device():
    # alpha = A^-1 y carries a gradient (the joint fit differentiates the
    # estimates K alpha); held against autograd of the one-device solve.
    d = _problem(70, 4)
    w = np.random.default_rng(9).normal(size=70)

    def value(factors):
        var, scales = _t(VAR, grad=True), _t(SCALES, grad=True)
        y = _t(d["y"], grad=True)
        alpha = factors(_kernels(var, scales), y)
        return torch.autograd.grad(torch.dot(alpha, _t(w)), (var, scales, y))

    def one_device(k, y):
        x, noise = _t(d["x"]), _t(d["noise"])
        return solve_chol(safe_cholesky(TK.gram(k, x, x) + torch.diag(noise)), y)

    def sharded(k, y):
        return sharded_dense_factors(k, _t(d["x"]), y, _t(d["noise"]), cpu_mesh(4))[2]

    for got, want in zip(value(sharded), value(one_device)):
        close(got, want, rtol=1e-8, atol=1e-12)


def test_sharded_dense_factors_match_jax_mesh():
    # The one direct comparison with JAX's own distributed factorisation.
    d = _problem(40, 5)
    got = sharded_dense_factors(_kernels(_t(VAR), _t(SCALES)), _t(d["x"]), _t(d["y"]),
                                _t(d["noise"]), cpu_mesh(4))
    jmesh = j_make_mesh(4, devices=jax.devices("cpu"))
    want = jax.jit(lambda var, scales, d: j_sharded_dense_factors(
        _kernels(var, scales), d["x"], d["y"], d["noise"], jmesh))(*J_ARGS, _jd(d))
    for a, b in zip(got, want):
        close(a, b, rtol=1e-8, atol=1e-12)


def test_gp_core_shards_under_mesh():
    d = _problem(48, 6)
    tf = TGP(_kernels(_t(VAR), _t(SCALES)))
    x, z, y, noise = (_t(d[k]) for k in ("x", "z", "y", "noise"))
    with gpar_torch.use_mesh(cpu_mesh(8), min_rows=8):
        dense = TObs(tf(x, noise), y)
        sparse = TPseudoObs(tf(z), tf(x, noise), y)
        post = (tf | dense).mean(x)
    assert dense.logpdf_val is not None and dense.alpha is not None
    (w_logpdf, _, w_post), w_sparse = _jax_obs(*J_ARGS, _jd(d))
    close(dense.logpdf, w_logpdf, rtol=1e-8)
    close(post, w_post, rtol=1e-8, atol=1e-10)
    for a, b in zip((sparse.elbo, sparse.Lm, sparse.LB, sparse.beta), w_sparse):
        close(a, b, rtol=1e-8, atol=1e-12)
    # Below the row threshold the one-device branch runs.
    with gpar_torch.use_mesh(cpu_mesh(8), min_rows=1024):
        assert TObs(tf(x, noise), y).logpdf_val is None


def test_sharded_sample_batch():
    r = np.random.default_rng(8)
    F, m = _t(r.normal(size=(5, 5))), _t(r.normal(size=5))
    normals = _t(r.normal(size=(16, 5)))

    def sample_fn(z):
        return m.to(z.device) + z @ F.to(z.device).T

    close(sharded_sample_batch(sample_fn, normals, cpu_mesh(8)), sample_fn(normals), rtol=1e-14)
    with pytest.raises(ValueError, match="do not split"):
        sharded_sample_batch(sample_fn, normals[:5], cpu_mesh(8))
