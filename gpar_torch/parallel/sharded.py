"""Row-sharded sparse GP statistics and sample-split sampling over a
:class:`~gpar_torch.parallel.mesh.Mesh`: the counterpart of
``gpar_tpu/parallel/sharded.py``.

- **Rows (``dp``).**  The collapsed Titsias ELBO decomposes over data rows
  given the inducing-point statistics: each shard computes an (m, m)
  moment matrix, an m-vector and scalars from its rows, they are summed
  across the shards (:func:`~gpar_torch.parallel.mesh.psum`), the O(m^3)
  solve runs once, and one scalar sum closes the quadratic form.  Each
  shard's ``Kmn`` panel, (m, n / P), is one call of ``ops.kernels.gram``:
  the Gram kernel on the card.
- **Samples.**  Monte-Carlo draws are independent given the posterior, so
  the sample axis splits into contiguous per-shard chunks
  (:func:`sharded_sample_batch`).

Gradients flow through ordinary autograd across the shards' tensors.
"""

import torch

from ..config import check_single_process
from ..ops.kernels import gram, kdiag
from ..ops.linalg import HOST, matvec, solve_lower, titsias_assemble, titsias_solve
from .mesh import Mesh, broadcast, canonical, devices_of, psum, split_rows, to_device

__all__ = [
    "make_mesh",
    "pad_rows",
    "sharded_sample_batch",
    "sharded_titsias_elbo",
    "sharded_titsias_factors",
    "sharded_titsias_panels",
    "titsias_psum_body",
]


def make_mesh(n_devices=None, axis="dp", devices=None):
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (default every
    visible CUDA device).  ``devices`` may repeat one device: ``make_mesh(4,
    devices=[torch.device("cuda")] * 4)`` is a virtual mesh of one card.

    Single-process only, as in the JAX package (``gpar_tpu/parallel/
    sharded.py:52-83``): in one rank of a multi-process ``torch.distributed``
    group this raises ``NotImplementedError``; with fewer devices than
    ``n_devices`` it raises ``ValueError`` rather than hand back a smaller
    mesh."""
    check_single_process()
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [canonical(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            kind = devices[0].type if devices else "cuda"
            raise ValueError(
                f"make_mesh({n_devices}) with only {len(devices)} "
                f"device(s) available ({kind}); pass devices= explicitly "
                f"(e.g. [torch.device('cpu')] * {n_devices})."
            )
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh() found no CUDA device; pass devices= explicitly.")
    return Mesh(tuple(devices), (axis,))


def pad_rows(arr, multiple, value=0.0):
    """Pad axis 0 up to a multiple of ``multiple``: ``(arr, mask)``, the mask
    1 on the original rows and 0 on the padding."""
    n = arr.shape[0]
    n_pad = (-n) % multiple
    mask = torch.cat([arr.new_ones(n), arr.new_zeros(n_pad)])
    if n_pad == 0:
        return arr, mask
    fill = arr.new_full((n_pad, *arr.shape[1:]), value)
    return torch.cat([arr, fill]), mask


def titsias_psum_body(Lm, A0, knn_local, y, noise_diag, mask, jitter=HOST):
    """The shard-summed collapsed Titsias ELBO and posterior factors from
    each shard's panels (``gpar_tpu/parallel/sharded.py:98-146``): every
    argument but ``Lm`` is a list with one tensor per shard.

    Per shard ``G = A0 D^-1 A0^T``, ``u = A0 D^-1 r``, ``log det D``, the
    clamped Nystrom trace and the row count, summed over the shards; one
    :func:`~gpar_torch.ops.linalg.titsias_solve` on shard 0's device (the
    single source the one-device path uses, so the two cannot drift); then
    per shard ``est = A0^T w`` and one summed quadratic form.  Masked rows
    (``mask`` 0) have ``D^-1 = 0`` and add nothing.  A batch axis in front
    of every tensor passes through, as in ``titsias_factors``.

    Args:
        Lm: (m, m) Cholesky factor of ``Kmm``, on shard 0's device.
        A0: per shard (m, n_local) ``Lm^-1 Kmn``.
        knn_local / y / noise_diag / mask: per shard (n_local,) prior
            variances, residuals, per-point noise and 0/1 validity.
        jitter: as in ``ops.linalg.titsias_factors``.

    Returns ``(elbo, LB, beta)`` on shard 0's device."""
    stats = []
    for a0, knn, yy, noise, mk in zip(A0, knn_local, y, noise_diag, mask):
        r = yy * mk
        d_inv = mk / noise
        qnn = torch.sum(a0 * a0, dim=-2)
        stats.append((
            (a0 * d_inv[..., None, :]) @ a0.mT,
            matvec(a0, r * d_inv),
            torch.sum(torch.log(noise) * mk, dim=-1),
            torch.sum(torch.clamp_min(knn - qnn, 0.0) * d_inv, dim=-1),
            torch.sum(mk, dim=-1),
        ))
    G, u, logdet_d, trace_num, n_total = (psum(list(s)) for s in zip(*stats))
    LB, w, beta = titsias_solve(G, u, Lm, jitter)
    quads = []
    for a0, yy, noise, mk, w_s in zip(A0, y, noise_diag, mask, broadcast(w, devices_of(A0))):
        r = yy * mk
        quads.append(torch.sum(r * (r - matvec(a0.mT, w_s)) * (mk / noise), dim=-1))
    elbo = titsias_assemble(logdet_d, LB, psum(quads), trace_num, n_total)
    return elbo, LB, beta


def sharded_titsias_panels(Kmm, Kmn, knn, y, noise_diag, mask, jitter=HOST):
    """``(elbo, Lm, LB, beta)`` of ``ops.linalg.titsias_factors`` from
    per-shard panels: ``Kmm`` (m, m) on shard 0's device, and per shard
    ``Kmn`` (m, n_local), ``knn``, ``y`` (the residual), ``noise_diag`` and
    ``mask``.  The factorisation of ``Kmm`` and the O(m^3) solve run once;
    ``jitter`` as in ``titsias_factors``."""
    Lm = jitter.cholesky(Kmm)
    A0 = [solve_lower(L_s, k) for L_s, k in zip(broadcast(Lm, devices_of(Kmn)), Kmn)]
    elbo, LB, beta = titsias_psum_body(Lm, A0, knn, y, noise_diag, mask, jitter)
    return elbo, Lm, LB, beta


def _shard_inputs(kernel, z, x, y, noise_diag, mask, mesh):
    """Per shard the kernel tree, inducing inputs and the shard's rows."""
    kernels = [to_device(kernel, d) for d in mesh.devices]
    rows = [split_rows(t, mesh) for t in (x, y, noise_diag, mask)]
    return kernels, broadcast(z, mesh.devices), rows


def sharded_titsias_factors(kernel, z, x, y, noise_diag, mask, mesh, axis="dp"):
    """The collapsed Titsias ELBO and the posterior factors ``Lm``, ``LB``,
    ``beta`` of ``gp/core.PseudoObs`` with the rows of ``(x, y, noise_diag,
    mask)`` sharded over ``mesh`` (``gpar_tpu/parallel/sharded.py:
    191-221``): per shard ``Kmn = gram(kernel, z, x_shard)`` and the
    shard's statistics, one sum of (m, m) + m + 3 numbers, the solve once.
    ``x`` has a multiple of ``mesh.size`` rows (:func:`pad_rows`); ``axis``
    names the mesh axis (the mesh has one).

    Returns ``(elbo, Lm, LB, beta)`` on shard 0's device."""
    kernels, zs, (xs, ys, noises, masks) = _shard_inputs(kernel, z, x, y, noise_diag, mask, mesh)
    Kmn = [gram(k, zz, xx) for k, zz, xx in zip(kernels, zs, xs)]
    knn = [kdiag(k, xx) for k, xx in zip(kernels, xs)]
    return sharded_titsias_panels(gram(kernel, z, z), Kmn, knn, ys, noises, masks)


def sharded_titsias_elbo(kernel, z, x, y, noise_diag, mask, mesh, axis="dp"):
    """The collapsed Titsias ELBO of :func:`sharded_titsias_factors`
    (``gpar_tpu/parallel/sharded.py:156-188``): ``ops.linalg.titsias_elbo``
    on the unmasked rows."""
    return sharded_titsias_factors(kernel, z, x, y, noise_diag, mask, mesh, axis)[0]


def sharded_sample_batch(sample_fn, normals, mesh, axis="dp"):
    """Draws of ``sample_fn`` with the batch of standard normals split over
    ``mesh`` (``gpar_tpu/parallel/sharded.py:224-236``, whose key batch the
    port's normals replace): ``normals`` (S, ...) with S a multiple of
    ``mesh.size`` is cut into contiguous chunks, chunk ``s`` moved to shard
    ``s``'s device and passed to ``sample_fn``, which maps a (S / P, ...)
    batch of normals to its draws; the draws are concatenated on shard 0's
    device in sample order."""
    return torch.cat([sample_fn(c).to(mesh.home) for c in split_rows(normals, mesh)])
