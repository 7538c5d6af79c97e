"""L-BFGS hyperparameter optimisation over name-filtered latents — port of
``gpar_tpu/params/optim.py`` (``varz.torch.minimise_l_bfgs_b``,
``gpar/regression.py:10,459``) for single-start fits.

Box constraints are unnecessary: every bound is a store transform
(``params/store.py``).  The gradient is ``torch.autograd.grad`` of the
objective evaluated at a latent vector that requires grad.  The scan-fused
fit's counterpart of ``lbfgs_traced_restarts`` (``optim.py:44-80``) is
:func:`check_restarts` and the step's device-state L-BFGS
(``models/fused.py``).
"""

from .lbfgs import lbfgs_minimize

__all__ = ["minimise_l_bfgs_b", "check_restarts"]


def check_restarts(restarts):
    """Only single-start fits are ported (multi-start is ROADMAP A10.6)."""
    if restarts != 1:
        raise NotImplementedError("gpar_torch: restarts > 1 is not ported yet")


def minimise_l_bfgs_b(
    objective, vs, names=None, iters=1000, gtol=1e-9, memory_size=10, restarts=1
):
    """Minimise ``objective(vs)`` over the latents of the name-matched
    variables; ``vs`` is updated in place with the optimum.

    Returns ``(f0, f, iterations)``: the objective at the initial and the
    final latents (floats) and the number of L-BFGS iterations taken.
    """
    check_restarts(restarts)
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

    z, f, it, f0 = lbfgs_minimize(fun, z0, iters=iters, gtol=gtol, memory=memory_size)
    vs.set_latent_vector(sel, z)
    return float(f0), float(f), int(it)
