"""Gaussian-process core: priors, finite-dimensional distributions,
observations and posteriors.

Port of the single-device slice of ``gpar_tpu/gp/core.py`` (the ``stheno``
surface the reference uses, ``gpar/model.py:5``):

- ``GP(kernel)``: zero-mean prior;
- ``f(x, noise)``: ``FDD`` with per-point noise (``noise / w``,
  ``gpar/model.py:270,287``), with ``sample``, ``chol`` and ``logpdf``;
- ``Obs(f(x, noise), y)``: exact observations; ``obs.logpdf`` is the
  marginal likelihood (``gpar/model.py:226``);
- ``PseudoObs(f(x_ind), f(x, noise), y)``: the collapsed Titsias ELBO
  (``gpar/model.py:286-289``) and the posterior factors, from one pass;
- ``f | obs``: the exact or the sparse posterior, with ``mean`` / ``cov``.

Under an active mesh (``gpar_torch.use_mesh``) with at least
``max(shard_min_rows, mesh size)`` rows, ``Obs`` and ``PseudoObs`` of a
zero-mean prior shard their rows over the mesh (``gpar_torch/parallel``),
as in ``gpar_tpu/gp/core.py:335-405``: the same quantities, the dense
factor from the distributed blocked Cholesky.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from ..config import config
from ..ops.kernels import Kernel, gram, kdiag
from ..ops.linalg import (
    floor_noise,
    mvn_logpdf_chol,
    psd_sample_factor,
    safe_cholesky,
    solve_chol,
    solve_lower,
    titsias_factors,
)

__all__ = [
    "GP",
    "FDD",
    "Obs",
    "PseudoObs",
    "DenseObs",
    "TitsiasObs",
    "PosteriorGP",
    "SparsePosteriorGP",
    "condition",
]


def _upcol(x):
    return x[:, None] if x.ndim == 1 else x


def _vec(y):
    return y[:, 0] if y.ndim == 2 else y


def _noise_vec(noise, n, like):
    """Broadcast scalar / vector noise to an (n,) vector floored at the
    dtype's jitter epsilon (:func:`floor_noise`); None stays None."""
    if noise is None:
        return None
    noise = torch.as_tensor(noise, dtype=like.dtype, device=like.device)
    if noise.ndim == 0:
        noise = noise.expand(n)
    return floor_noise(noise.reshape(n))


class AbstractGP:
    """Common GP surface: call, mean, condition."""

    def __call__(self, x, noise=None):
        x = _upcol(x)
        return FDD(self, x, _noise_vec(noise, x.shape[0], x))

    def mean(self, x):
        """Mean at inputs as an (n, 1) column (``gpar/model.py:299,305``)."""
        return self.mean_vec(_upcol(x))[:, None]

    def __or__(self, obs):
        return condition(self, obs)


@dataclass(frozen=True, eq=False)
class GP(AbstractGP):
    """Zero-mean GP prior (``gpar/regression.py:176-180``)."""

    kernel: Kernel

    def mean_vec(self, x):
        return x.new_zeros(x.shape[0])

    def cov(self, x, y=None):
        x = _upcol(x)
        y = x if y is None else _upcol(y)
        return gram(self.kernel, x, y)

    def cov_diag(self, x):
        return kdiag(self.kernel, _upcol(x))


@dataclass(frozen=True, eq=False)
class PosteriorGP(AbstractGP):
    """Exact posterior of a zero-mean GP given noisy observations; keeps the
    conditioning set so that a further exact conditioning refactors the
    union::

        mean(x*) = K(x*, X) alpha,  alpha = (K(X, X) + D)^{-1} y
        cov(x*, y*) = K(x*, y*) - V_x^T V_y,  V_x = L^{-1} K(X, x*).
    """

    kernel: Kernel
    x_data: torch.Tensor  # (n, d)
    y_data: torch.Tensor  # (n,)
    noise_diag: torch.Tensor  # (n,)
    L: torch.Tensor  # (n, n) chol of K + D
    alpha: torch.Tensor  # (n,)

    def mean_vec(self, x):
        return gram(self.kernel, x, self.x_data) @ self.alpha

    def cov(self, x, y=None):
        x = _upcol(x)
        y = x if y is None else _upcol(y)
        Vx = solve_lower(self.L, gram(self.kernel, self.x_data, x))
        Vy = Vx if y is x else solve_lower(self.L, gram(self.kernel, self.x_data, y))
        return gram(self.kernel, x, y) - Vx.T @ Vy

    def cov_diag(self, x):
        x = _upcol(x)
        Vx = solve_lower(self.L, gram(self.kernel, self.x_data, x))
        return kdiag(self.kernel, x) - torch.sum(Vx * Vx, dim=0)


@dataclass(frozen=True, eq=False)
class SparsePosteriorGP(AbstractGP):
    """Titsias variational posterior of a base GP::

        mean(x*) = m(x*) + K(x*, Z) beta
        cov(x*, y*) = K(x*, y*) - T1_x^T T1_y + T2_x^T T2_y,
        T1_x = Lm^{-1} K(Z, x*),  T2_x = LB^{-1} T1_x.
    """

    base: AbstractGP
    x_ind: torch.Tensor  # (m, d)
    Lm: torch.Tensor
    LB: torch.Tensor
    beta: torch.Tensor  # (m,)

    def mean_vec(self, x):
        return self.base.mean_vec(x) + self.base.cov(x, self.x_ind) @ self.beta

    def cov(self, x, y=None):
        x = _upcol(x)
        y = x if y is None else _upcol(y)
        T1x = solve_lower(self.Lm, self.base.cov(self.x_ind, x))
        T1y = T1x if y is x else solve_lower(self.Lm, self.base.cov(self.x_ind, y))
        T2x = solve_lower(self.LB, T1x)
        T2y = T2x if y is x else solve_lower(self.LB, T1y)
        return self.base.cov(x, y) - T1x.T @ T1y + T2x.T @ T2y

    def cov_diag(self, x):
        x = _upcol(x)
        T1x = solve_lower(self.Lm, self.base.cov(self.x_ind, x))
        T2x = solve_lower(self.LB, T1x)
        return self.base.cov_diag(x) - torch.sum(T1x * T1x, dim=0) + torch.sum(T2x * T2x, dim=0)


@dataclass(frozen=True, eq=False)
class FDD:
    """Finite-dimensional distribution ``f(x, noise)``; ``noise`` is None
    (latent) or an (n,) per-point variance vector."""

    f: AbstractGP
    x: torch.Tensor
    noise: Optional[torch.Tensor]

    def mean_vec(self):
        return self.f.mean_vec(self.x)

    def cov(self):
        K = self.f.cov(self.x)
        if self.noise is not None:
            K = K + torch.diag(self.noise)
        return K

    def chol(self):
        return safe_cholesky(self.cov())

    def logpdf(self, y):
        """Exact MVN log density (``tests/test_model.py:137-147``)."""
        return mvn_logpdf_chol(_vec(y), self.mean_vec(), self.chol())

    def sample(self, normals=None, generator=None, num_samples=None):
        """Joint MVN draw(s): (n, 1) for one sample, (num_samples, n, 1)
        otherwise.  ``normals`` supplies the standard normals — shape (n,)
        or (num_samples, n) — else they are drawn from ``generator``.

        The factor is :func:`psd_sample_factor`: a near-interpolating
        posterior can be indefinite beyond jitter repair, and sampling then
        clamps the spectrum rather than returning NaNs."""
        n = self.x.shape[0]
        L = psd_sample_factor(self.cov())
        m = self.mean_vec()
        if normals is None:
            shape = (n,) if num_samples is None else (num_samples, n)
            normals = torch.randn(
                shape, generator=generator, dtype=self.x.dtype, device=self.x.device
            )
        if normals.ndim == 1:
            return (m + L @ normals)[:, None]
        return (m + normals @ L.T)[..., None]


@dataclass(frozen=True, eq=False)
class DenseObs:
    """Exact observations with the factor of ``cov + D``.  Build via
    :func:`Obs`."""

    fdd: FDD
    y: torch.Tensor  # (n,)
    L: torch.Tensor  # chol of cov + D
    residual: torch.Tensor  # y - mean
    #: Set by the row-sharded path, which computes the log-density and
    #: ``(K + D)^-1 r`` in the factorisation's pass.
    logpdf_val: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None

    @property
    def logpdf(self):
        """Marginal likelihood of ``y`` under the FDD: for a prior ``f`` the
        training objective's term (``gpar/model.py:226``); zero for no
        rows."""
        if self.y.shape[0] == 0:
            return self.fdd.x.new_zeros(())
        if self.logpdf_val is not None:
            return self.logpdf_val
        return mvn_logpdf_chol(self.residual, torch.zeros_like(self.residual), self.L)


def _mesh_for(f, n):
    """The active mesh when ``n`` rows of the zero-mean prior ``f`` shard
    over it, else None."""
    mesh = config.mesh
    if isinstance(f, GP) and mesh is not None and n >= max(config.shard_min_rows, mesh.size):
        return mesh
    return None


def Obs(fdd, y):
    """Exact observations ``Obs(f(x, noise), y)`` (``gpar/model.py:289``);
    under a mesh the rows of a zero-mean prior's covariance shard over it
    (``parallel.dense.sharded_dense_factors``)."""
    y = _vec(y)
    mesh = _mesh_for(fdd.f, fdd.x.shape[0])
    if mesh is not None:
        from ..parallel.dense import sharded_dense_factors

        noise = fdd.noise if fdd.noise is not None else fdd.x.new_zeros(fdd.x.shape[0])
        logpdf, L, alpha = sharded_dense_factors(fdd.f.kernel, fdd.x, y, noise, mesh,
                                                 axis=config.shard_axis)
        return DenseObs(fdd=fdd, y=y, L=L, residual=y, logpdf_val=logpdf, alpha=alpha)
    return DenseObs(fdd=fdd, y=y, L=fdd.chol(), residual=y - fdd.mean_vec())


@dataclass(frozen=True, eq=False)
class TitsiasObs:
    """Titsias inducing-point observations with the m x m factors shared by
    the ELBO and the sparse posterior.  Build via :func:`PseudoObs`."""

    fdd_ind: FDD
    fdd: FDD
    y: torch.Tensor
    Lm: torch.Tensor
    LB: torch.Tensor
    beta: torch.Tensor
    elbo: torch.Tensor

    @property
    def logpdf(self):
        """The collapsed ELBO (a lower bound on the exact marginal
        likelihood, equal to it when the inducing inputs are the data)."""
        return self.elbo


def PseudoObs(fdd_ind, fdd, y):
    """Titsias observations ``PseudoObs(f(x_ind), f(x, noise), y)``
    (``gpar/model.py:287``); works on any base GP."""
    f = fdd.f
    y = _vec(y)
    x, z = fdd.x, fdd_ind.x
    if fdd.noise is None:
        raise ValueError("PseudoObs requires observation noise.")
    mesh = _mesh_for(f, x.shape[0])
    if mesh is not None:
        from ..parallel.sharded import pad_rows, sharded_titsias_factors

        xp, mask = pad_rows(x, mesh.size)
        yp, _ = pad_rows(y, mesh.size)
        noisep, _ = pad_rows(fdd.noise, mesh.size, value=1.0)
        elbo, Lm, LB, beta = sharded_titsias_factors(f.kernel, z, xp, yp, noisep, mask, mesh,
                                                     axis=config.shard_axis)
        return TitsiasObs(fdd_ind=fdd_ind, fdd=fdd, y=y, Lm=Lm, LB=LB, beta=beta, elbo=elbo)
    elbo, Lm, LB, beta = titsias_factors(
        f.cov(z), f.cov(z, x), f.cov_diag(x), y, f.mean_vec(x), fdd.noise
    )
    return TitsiasObs(fdd_ind=fdd_ind, fdd=fdd, y=y, Lm=Lm, LB=LB, beta=beta, elbo=elbo)



def condition(f, obs):
    """Posterior ``f | obs`` (``gpar/model.py:170,298``) for observations
    built from ``f`` (or a structurally identical process).  Exact
    observations of a prior reuse its factor; of an exact posterior, they
    condition it on the union of the data."""
    if f is not obs.fdd.f and type(f) is not type(obs.fdd.f):
        raise ValueError(
            "condition(f, obs): `obs` was built from a structurally different "
            "process than `f`; condition the process the observations came from."
        )
    if isinstance(obs, TitsiasObs):
        return SparsePosteriorGP(
            base=f, x_ind=obs.fdd_ind.x, Lm=obs.Lm, LB=obs.LB, beta=obs.beta
        )
    if not isinstance(obs, DenseObs):
        raise TypeError(f"Cannot condition on {type(obs)!r}")
    x_new, y_new = obs.fdd.x, obs.y
    noise_new = obs.fdd.noise
    if noise_new is None:
        noise_new = x_new.new_zeros(x_new.shape[0])
    if isinstance(f, GP):
        alpha = obs.alpha if obs.alpha is not None else solve_chol(obs.L, obs.residual)
        return PosteriorGP(kernel=f.kernel, x_data=x_new, y_data=y_new, noise_diag=noise_new,
                           L=obs.L, alpha=alpha)
    if isinstance(f, PosteriorGP):
        return _condition_dense(
            f.kernel,
            torch.cat([f.x_data, x_new], dim=0),
            torch.cat([f.y_data, y_new], dim=0),
            torch.cat([f.noise_diag, noise_new], dim=0),
        )
    raise NotImplementedError(f"Cannot condition {type(f)!r} on exact obs.")


def _condition_dense(kernel, x, y, noise_diag):
    L = safe_cholesky(gram(kernel, x, x) + torch.diag(noise_diag))
    return PosteriorGP(kernel=kernel, x_data=x, y_data=y, noise_diag=noise_diag, L=L,
                       alpha=solve_chol(L, y))
