"""L-BFGS hyperparameter optimisation over name-filtered latents — port of
``gpar_tpu/params/optim.py`` (``varz.torch.minimise_l_bfgs_b``,
``gpar/regression.py:10,459``), single- and multi-start.

Box constraints are unnecessary: every bound is a store transform
(``params/store.py``).  The gradient is ``torch.autograd.grad`` of the
objective evaluated at a latent vector that requires grad.  The JAX
package's multi-start building block ``lbfgs_traced_restarts``
(``optim.py:44-80``) is ``params.lbfgs.lbfgs_minimize_restarts`` here, and
the scan-fused fits' device-state L-BFGS runs its restarts as one batch
(``models/fused.py``).  This host-driven driver runs the starts of a
multi-start fit one after the other: each start's trajectory is the one
the JAX package's ``vmap`` gives it.  ``trace=`` is not ported, so neither
is its guard against restarts.
"""

import numpy as np
import torch

from .lbfgs import best_of, lbfgs_minimize

__all__ = ["minimise_l_bfgs_b", "restart_normals"]


def restart_normals(normals, shape, dtype, device, generator=None):
    """The standard normals of a multi-start fit's perturbations: the
    caller's (checked against ``shape``), or draws from ``generator``
    (default: the device's generator of ``utils.rng``)."""
    if normals is None:
        from ..utils.rng import default_generator

        gen = default_generator(device) if generator is None else generator
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)
    if isinstance(normals, np.ndarray):
        normals = normals.copy()  # a read-only array would be shared, not copied
    normals = torch.as_tensor(normals, dtype=dtype, device=device)
    if tuple(normals.shape) != tuple(shape):
        raise ValueError(f"restart normals have shape {tuple(normals.shape)}; "
                         f"expected {tuple(shape)}")
    return normals


def minimise_l_bfgs_b(
    objective, vs, names=None, iters=1000, gtol=1e-9, memory_size=10, restarts=1,
    restart_scale=1.0, generator=None, normals=None, stats=None,
):
    """Minimise ``objective(vs)`` over the latents of the name-matched
    variables; ``vs`` is updated in place with the optimum.

    ``restarts > 1``: one unperturbed start and ``restarts - 1`` starts
    perturbed by ``restart_scale`` times standard normals in the latent
    space (``normals`` (restarts - 1, d), else drawn from ``generator``),
    run one after the other; the best finite optimum is kept.

    ``stats`` (``lbfgs.new_stats()``) receives every start's host reads
    and backtracking counts.

    Returns ``(f0, f, iterations)``: the objective at the (unperturbed)
    initial and the final latents (floats) and the number of L-BFGS
    iterations the kept optimum took.
    """
    sel = vs.select(names)
    if not sel:
        # Variables are created lazily on first access.
        f0 = objective(vs)
        sel = vs.select(names)
        if not sel:
            return float(f0), float(f0), 0

    z0 = vs.latent_vector(sel)

    def fun(z):
        return objective(vs.with_latent_vector(sel, z))

    starts = [z0]
    if restarts > 1:
        noise = restart_normals(normals, (restarts - 1, z0.shape[0]), z0.dtype, z0.device,
                                generator)
        starts += list(z0[None] + restart_scale * noise)
    runs = [lbfgs_minimize(fun, s, iters=iters, gtol=gtol, memory=memory_size, stats=stats)
            for s in starts]
    best = int(best_of(torch.stack([f for _, f, _, _ in runs]))) if restarts > 1 else 0
    z, f, it, _ = runs[best]
    vs.set_latent_vector(sel, z)
    return float(runs[0][3]), float(f), int(it)
