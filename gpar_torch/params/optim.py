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
the JAX package's ``vmap`` gives it.

``trace=True`` runs the JAX package's host-side printing driver
(``optim.py:126-176``) instead: optax's L-BFGS with its zoom line search
(:mod:`.zoom`, the port's own copy), one line ``  lbfgs iter k: objective
v`` after each iteration, single-start only (``restarts > 1`` raises before
any evaluation).
"""

import numpy as np
import torch

from ..utils.spans import span
from .lbfgs import _objective, best_of, lbfgs_minimize, new_stats
from .zoom import lbfgs_init, lbfgs_update, value_and_grad_from_state

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


def lbfgs_traced_host(fun, z0, iters=1000, gtol=1e-9, memory_size=10, stats=None):
    """The JAX package's ``trace=True`` loop (``optim.py:143-176``): optax's
    ``lbfgs`` from ``z0``, printing the objective after every iteration and
    stopping once ``not (max|g| > gtol)`` or the value is not finite.  One
    host read per iteration (the value, ``max|g|`` and whether ``z`` is
    finite) besides the line search's one per step.  A non-finite end
    returns to ``z0`` and ``fun(z0)``.  Returns ``(z, f, iterations, f0)``,
    ``f0`` the objective at ``z0`` (the first iteration's evaluation)."""
    stats = new_stats() if stats is None else stats
    stats.setdefault("evaluations", 0)
    evaluate = _objective(fun)[0]

    def value_and_grad(z):
        stats["evaluations"] += 1
        return evaluate(z)

    z0 = z0.detach()
    z, state = z0, lbfgs_init(z0, memory_size)
    f0, finite, it = None, False, 0
    while it < iters:
        value, grad = value_and_grad_from_state(value_and_grad, z, state, finite)
        if f0 is None:
            f0 = value
        updates, state = lbfgs_update(grad, state, z, value, value_and_grad, stats=stats)
        stats["linesearch_episodes"] += 1
        stats["linesearch_trials"] += state.num_linesearch_steps
        z = z + updates
        it += 1
        stats["host_syncs"] += 1
        with span("gpar.fit.read"):
            v, gmax, z_finite = torch.stack([state.value, torch.max(torch.abs(state.grad)),
                                             torch.all(torch.isfinite(z)).to(z.dtype)]).tolist()
        print(f"  lbfgs iter {it}: objective {v:.6f}")
        finite = bool(np.isfinite(v))
        if not (gmax > gtol) or not finite:
            break
    if it and finite and z_finite:
        return z, state.value, it, f0
    with torch.no_grad():
        f = fun(z0)
    return z0, f, it, f if f0 is None else f0


def minimise_l_bfgs_b(
    objective, vs, names=None, iters=1000, gtol=1e-9, memory_size=10, restarts=1,
    restart_scale=1.0, generator=None, normals=None, stats=None, trace=False,
):
    """Minimise ``objective(vs)`` over the latents of the name-matched
    variables; ``vs`` is updated in place with the optimum.

    ``restarts > 1``: one unperturbed start and ``restarts - 1`` starts
    perturbed by ``restart_scale`` times standard normals in the latent
    space (``normals`` (restarts - 1, d), else drawn from ``generator``),
    run one after the other; the best finite optimum is kept.

    ``stats`` (``lbfgs.new_stats()``) receives every start's host reads
    and backtracking counts.

    ``trace=True``: :func:`lbfgs_traced_host`, optax's zoom-line-search
    L-BFGS printing one line per iteration (``stats`` also counts its
    ``evaluations``; ``linesearch_trials`` its line-search steps);
    ``restarts > 1`` raises ``ValueError`` before any evaluation.

    Returns ``(f0, f, iterations)``: the objective at the (unperturbed)
    initial and the final latents (floats) and the number of L-BFGS
    iterations the kept optimum took.
    """
    if trace and restarts > 1:
        # Running one start where several were asked for would blame the
        # model for a worse optimum (the JAX package's guard).
        raise ValueError("trace=True runs the host-side single-start driver; it does not "
                         "support restarts>1. Drop trace= or restarts=.")
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

    if trace:
        z, f, it, f0 = lbfgs_traced_host(fun, z0, iters=iters, gtol=gtol,
                                         memory_size=memory_size, stats=stats)
        vs.set_latent_vector(sel, z)
        return float(f0), float(f), int(it)

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
