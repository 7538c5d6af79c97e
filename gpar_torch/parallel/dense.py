"""The row-sharded exact dense GP path: the distributed blocked Cholesky,
its triangular solves and the exact marginal likelihood with a
distributed backward (the counterpart of ``gpar_tpu/parallel/dense.py``).

- **Row sharding.**  Shard ``s`` owns the contiguous rows ``s nloc ..
  (s + 1) nloc`` of the jittered covariance ``A = K + D + eps I``, built
  on its device as ``gram(kernel, x_local, x_full)``: the Gram kernel on
  the card at (nloc, n), and O(n^2 / P) memory per shard.
- **Right-looking blocked Cholesky** (:func:`_dist_cholesky`).  Per panel
  of ``block`` columns the owner's diagonal block is factored
  (``torch.linalg.cholesky_ex``; in a single process "broadcasting" it is
  an index), every shard solves its own rows below the panel against it
  (``solve_triangular``), the solved panel is gathered (:func:`all_gather`)
  and each shard updates its trailing rows with one matmul.  The panel
  width divides ``nloc``, so a diagonal block never straddles two shards.
- **Solves** by block substitution with one block-sized sum per panel.
- **Backward** (:class:`_CholLogpdf`): the gradient of the log-density
  needs the rows of ``A^-1``; each shard solves the columns of ``L^-1``
  that belong to its rows, they are gathered, and ``Sinv_rows = X^T L^-1``
  closes it on the shard.  The gradient of ``alpha = A^-1 r`` takes one
  more pair of distributed solves.  The hyperparameters' gradients then
  flow through each shard's Gram rows by ordinary autograd.

These are library calls, as in the JAX package, where they are XLA and
not Pallas: no kernel is written for them.

Padding: rows are padded to ``P nloc`` and masked out; a masked row is an
identity row (unit diagonal, zero elsewhere, zero residual), so it adds
exactly nothing to the log-determinant, the quadratic form or any
gradient.

Jitter: ``resolve_epsilon`` is added once; there is no escalating retry
ladder inside the distributed factorisation (a failed panel makes the
factor, and the log-density, NaN), so the single-device path equals this
one whenever its first jitter rung succeeds.
"""

import torch
import torch.nn.functional as F

from ..config import config
from ..ops.kernels import gram
from ..ops.linalg import LOG_2PI, resolve_epsilon
from .mesh import all_gather, psum, split_rows, to_device

__all__ = ["chol_logpdf", "masked_rows", "sharded_dense_factors", "sharded_dense_logpdf"]


def _pad_geometry(n, n_devices, block_cfg):
    """Static padding plan (``gpar_tpu/parallel/dense.py:276-284``):
    ``(nloc, block)``, rows per shard (a multiple of the panel width) and
    the panel width, shrunk for small problems so that the padding stays
    bounded."""
    nloc0 = -(-n // n_devices)
    pow2 = 1 << (max(16, nloc0).bit_length() - 1)  # largest power of 2 <= nloc0
    block = int(min(block_cfg, pow2))
    nloc = -(-nloc0 // block) * block
    return nloc, block


def _chol_block(A):
    """The Cholesky factor of a diagonal block, NaN where it fails (no host
    read, as JAX's ``jnp.linalg.cholesky``)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _solve_lower(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


def _dist_cholesky(A, block):
    """Right-looking blocked Cholesky of the row-sharded SPD matrix whose
    shards are ``A`` (each (nloc, n)); returns the shards of the lower
    factor.  ``A`` is not changed."""
    P, (nloc, n) = len(A), A[0].shape
    A = [a.clone() for a in A]
    L = [torch.zeros_like(a) for a in A]
    for jb in range(0, n, block):
        owner, off = divmod(jb, nloc)
        cols, rest = slice(jb, jb + block), slice(jb + block, n)
        Ljj = _chol_block(A[owner][off:off + block, cols])
        L[owner][off:off + block, cols] = Ljj
        subs = []  # each shard's solved rows below the panel
        for s in range(owner, P):
            r0 = off + block if s == owner else 0
            Ls = Ljj.to(A[s].device)
            sub = torch.linalg.solve_triangular(Ls.mT, A[s][r0:, cols], upper=True, left=False)
            L[s][r0:, cols] = sub
            subs.append(sub)
        below = torch.cat([t.to(A[owner].device) for t in subs])  # rows jb + block .. n
        for s, sub in zip(range(owner, P), subs):
            r0 = off + block if s == owner else 0
            A[s][r0:, rest] -= sub @ below.to(sub.device).mT
    return L


def _dist_forward_solve(L, r, block):
    """``v = L^-1 r`` for the row-sharded ``r``: replicated (n,) on shard 0's
    device."""
    P, (nloc, n) = len(L), L[0].shape
    home = L[0].device
    v = torch.zeros(n, dtype=L[0].dtype, device=home)
    acc = [torch.zeros(nloc, dtype=l.dtype, device=l.device) for l in L]
    for jb in range(0, n, block):
        owner, off = divmod(jb, nloc)
        rhs = r[owner][off:off + block] - acc[owner][off:off + block]
        vj = _solve_lower(L[owner][off:off + block, jb:jb + block], rhs[:, None])[:, 0]
        v[jb:jb + block] = vj.to(home)
        for s in range(owner, P):
            acc[s] += L[s][:, jb:jb + block] @ vj.to(L[s].device)
    return v


def _dist_back_solve(L, v, block):
    """``a = L^-T v`` for the replicated ``v``: replicated (n,) on shard 0's
    device.  Entries not solved yet are zero, so each shard's contribution
    to a panel is its column panel against its part of ``a``."""
    P, (nloc, n) = len(L), L[0].shape
    a = torch.zeros_like(v)
    for jb in reversed(range(0, n, block)):
        owner, off = divmod(jb, nloc)
        part = psum([L[s][:, jb:jb + block].mT @ a[s * nloc:(s + 1) * nloc].to(L[s].device)
                     for s in range(owner, P)])
        Lblk = L[owner][off:off + block, jb:jb + block]
        rhs = (v[jb:jb + block] - part.to(v.device)).to(Lblk.device)
        aj = torch.linalg.solve_triangular(Lblk.mT, rhs[:, None], upper=True)[:, 0]
        a[jb:jb + block] = aj.to(a.device)
    return a


def _dist_inv_columns(L, block):
    """Per shard the columns of ``L^-1`` that belong to its rows, ``X_s =
    L^-1 E_s`` (n, nloc), by block forward substitution.  ``L^-1`` is lower
    triangular, so the rows of ``X_s`` above shard ``s``'s first row are
    zero and only panels at or after it are solved."""
    P, (nloc, n) = len(L), L[0].shape
    X = [torch.zeros((n, nloc), dtype=l.dtype, device=l.device) for l in L]
    for jb in range(0, n, block):
        owner, off = divmod(jb, nloc)
        Lblk = L[owner][off:off + block, jb:jb + block]
        Lrow = L[owner][off:off + block, :jb]
        for s in range(owner + 1):
            d = X[s].device
            rhs = -(Lrow.to(d) @ X[s][:jb])
            if s == owner:
                rhs[:, off:off + block].diagonal().add_(1.0)  # this shard's identity columns
            X[s][jb:jb + block] = _solve_lower(Lblk.to(d), rhs)
    return X


def _local_diag(L_s, s):
    nloc = L_s.shape[0]
    return torch.diagonal(L_s[:, s * nloc:(s + 1) * nloc])


class _CholLogpdf(torch.autograd.Function):
    """``(logpdf, *L, alpha)`` of ``N(r | 0, A)`` from the row-sharded
    (masked, jittered) covariance: the counterpart of JAX's
    ``_chol_logpdf_core`` and its custom VJP (``gpar_tpu/parallel/dense.py:
    217-273``).  Inputs: ``block``, then the P shards of ``A``, of ``r`` and
    of the mask.  ``logpdf`` and the replicated ``alpha = A^-1 r`` carry a
    gradient, the shards of ``L`` none.  JAX's VJP drops ``alpha``'s too; the
    joint fit (``fit(fix=False)``) differentiates through the estimates
    ``K alpha`` that impute the next layer's inputs, and without that term
    its gradient under a mesh would differ from the one-device fit's."""

    @staticmethod
    def forward(ctx, block, *shards):
        P = len(shards) // 3
        A, r, mask = shards[:P], shards[P:2 * P], shards[2 * P:]
        L = _dist_cholesky(A, block)
        v = _dist_forward_solve(L, r, block)
        alpha = _dist_back_solve(L, v, block)
        logdet = psum([torch.sum(torch.log(_local_diag(l, s)) * m)
                       for s, (l, m) in enumerate(zip(L, mask))])
        n_eff = psum([torch.sum(m) for m in mask])
        logpdf = -0.5 * n_eff * LOG_2PI - logdet - 0.5 * torch.dot(v, v)
        ctx.block, ctx.P = block, P
        ctx.save_for_backward(*L, alpha)
        ctx.mark_non_differentiable(*L)
        ctx.set_materialize_grads(False)
        return (logpdf, *L, alpha)

    @staticmethod
    def backward(ctx, g, *grads):
        *L, alpha = ctx.saved_tensors
        P, nloc, block = ctx.P, L[0].shape[0], ctx.block
        g_alpha = grads[-1]
        A_bar = [torch.zeros_like(l) for l in L]
        r_bar = [torch.zeros(nloc, dtype=l.dtype, device=l.device) for l in L]
        if g is not None:
            # d logpdf / dA = (alpha alpha^T - A^-1) / 2, d logpdf / dr = -alpha.
            X = _dist_inv_columns(L, block)
            T = all_gather(X, dim=1)  # L^-1, (n, n), per device
            for s, (x_s, t_s) in enumerate(zip(X, T)):
                d = x_s.device
                a_all, g_s = alpha.to(d), g.to(d)
                a_loc = a_all[s * nloc:(s + 1) * nloc]
                A_bar[s] += (0.5 * g_s) * (a_loc[:, None] * a_all[None, :] - x_s.mT @ t_s)
                r_bar[s] -= g_s * a_loc
        if g_alpha is not None:
            # alpha = A^-1 r: with b = A^-1 g_alpha, dA gets -b alpha^T, dr b.
            g_parts = [g_alpha[s * nloc:(s + 1) * nloc].to(l.device) for s, l in enumerate(L)]
            b = _dist_back_solve(L, _dist_forward_solve(L, g_parts, block), block)
            for s, l in enumerate(L):
                b_loc, a_all = b[s * nloc:(s + 1) * nloc].to(l.device), alpha.to(l.device)
                A_bar[s] -= b_loc[:, None] * a_all[None, :]
                r_bar[s] += b_loc
        return (None, *A_bar, *r_bar, *([None] * P))


def chol_logpdf(A, r, mask, block):
    """``(logpdf, L_shards, alpha)`` of :class:`_CholLogpdf` for the shards
    ``A``, ``r`` and ``mask`` (lists); ``L_shards`` carries no gradient."""
    logpdf, *rest = _CholLogpdf.apply(block, *A, *r, *mask)
    return logpdf, rest[:-1], rest[-1]


def masked_rows(K_local, mask, mask_full, diag_term, s):
    """Shard ``s``'s rows of the masked covariance: ``K_local`` (nloc, n)
    times both masks, plus ``diag_term`` (nloc,) on its diagonal, the block
    of columns ``s nloc .. (s + 1) nloc``."""
    nloc, n = K_local.shape
    A = K_local * mask[:, None] * mask_full[None, :]
    return A + F.pad(torch.diag(diag_term), (s * nloc, n - (s + 1) * nloc))


def sharded_dense_factors(kernel, x, y, noise_diag, mesh, axis="dp", block=None, epsilon=None):
    """The exact dense log-density and posterior factors of a zero-mean
    prior, rows sharded over ``mesh`` (``gpar_tpu/parallel/dense.py:
    287-357``): the counterpart of ``Obs(f(x, noise), y).logpdf`` on one
    device.  Each shard builds its rows of the Gram on its device, the
    blocked Cholesky factors them together, and the gradient flows back
    through :class:`_CholLogpdf` into each shard's Gram rows.

    Args:
        kernel: the kernel tree.
        x: (n, d) inputs, padded here (no divisibility needed).
        y: (n,) observations; noise_diag: (n,) per-point noise.
        mesh: a :class:`~gpar_torch.parallel.mesh.Mesh`; ``axis`` its axis.
        block: panel width (default ``config.dense_shard_block``).
        epsilon: jitter (default ``resolve_epsilon``).

    Returns ``(logpdf, L, alpha)`` on shard 0's device: ``L`` the (n, n)
    lower Cholesky factor of ``K + D + eps I`` gathered (without gradient),
    ``alpha = (K + D + eps I)^-1 y``."""
    block = config.dense_shard_block if block is None else block
    n, P = x.shape[0], mesh.size
    eps = resolve_epsilon(x.dtype, epsilon)
    nloc, block = _pad_geometry(n, P, block)
    pad = P * nloc - n
    xp = F.pad(x, (0, 0, 0, pad))
    yp = F.pad(y.reshape(-1), (0, pad))
    noisep = F.pad(noise_diag.reshape(-1), (0, pad), value=1.0)
    maskp = F.pad(x.new_ones(n), (0, pad))
    xs, ys, noises, masks = (split_rows(t, mesh) for t in (xp, yp, noisep, maskp))
    x_full, mask_full = all_gather(xs), all_gather(masks)
    A, r = [], []
    for s, d in enumerate(mesh.devices):
        K_local = gram(to_device(kernel, d), xs[s], x_full[s])
        diag_term = masks[s] * (noises[s] + eps) + (1.0 - masks[s])
        A.append(masked_rows(K_local, masks[s], mask_full[s], diag_term, s))
        r.append(ys[s] * masks[s])
    logpdf, L, alpha = chol_logpdf(A, r, masks, block)
    L_full = torch.cat([l.to(mesh.home) for l in L])
    return logpdf, L_full[:n, :n], alpha[:n]


def sharded_dense_logpdf(kernel, x, y, noise_diag, mesh, axis="dp", block=None, epsilon=None):
    """The log-density of :func:`sharded_dense_factors`."""
    return sharded_dense_factors(kernel, x, y, noise_diag, mesh, axis, block, epsilon)[0]

