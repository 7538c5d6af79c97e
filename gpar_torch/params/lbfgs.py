"""Compact L-BFGS: two-loop recursion over a bounded history plus Armijo
backtracking.

Port of ``gpar_tpu/params/lbfgs.py`` with the same trajectory: the same
two-loop recursion and initial Hessian scaling, the same conservative
first step while no curvature pair is stored, Armijo backtracking by
halving (at most ``max_linesearch`` trials, non-finite trial values
shrink the step like a failed test), the ``s.y <= 1e-10 |s||y|`` skip
guard, the same convergence tests and the non-finite end-state guard.
``torch.optim.LBFGS`` follows a different trajectory and is not used.

The loop runs on the host: each linesearch test reads one scalar back
from the device.
"""

import torch

__all__ = ["lbfgs_minimize"]


def _value_and_grad(fun, z):
    z = z.detach().requires_grad_(True)
    with torch.enable_grad():
        f = fun(z)
        (g,) = torch.autograd.grad(f, z)
    return f.detach(), g


def _two_loop(g, S, Y, rho):
    """Standard two-loop recursion; ``S``/``Y``/``rho`` oldest first."""
    q = g
    alphas = []
    for s, y, r in zip(reversed(S), reversed(Y), reversed(rho)):
        a = r * torch.dot(s, q)
        q = q - a * y
        alphas.append(a)
    gamma = 1.0
    if S:
        yy = torch.dot(Y[-1], Y[-1])
        if yy > 0:
            gamma = 1.0 / (torch.clamp_min(rho[-1], 1e-300) * yy)
    r = gamma * q
    for s, y, rh, a in zip(S, Y, rho, reversed(alphas)):
        b = rh * torch.dot(y, r)
        r = r + s * (a - b)
    return -r


def lbfgs_minimize(
    fun,
    z0,
    iters=1000,
    gtol=1e-9,
    ftol=1e-12,
    memory=10,
    max_linesearch=25,
    c1=1e-4,
):
    """Minimise ``fun`` from ``z0``; returns ``(z, f, iterations_used, f0)``
    with ``f0`` the objective at ``z0``."""
    z0 = z0.detach()
    f0, g0 = _value_and_grad(fun, z0)
    z, f, g = z0, f0, g0
    S, Y, rho = [], [], []
    it = 0
    done = False
    while not done and it < iters:
        direction = _two_loop(g, S, Y, rho)
        dg = torch.dot(direction, g)
        # Steepest descent if the direction is not a descent direction.
        if not bool(torch.isfinite(dg)) or dg >= 0:
            direction = -g
            dg = -torch.dot(g, g)

        if not S:
            t = min(1.0, 1.0 / max(float(torch.sum(torch.abs(g))), 1e-12))
        else:
            t = 1.0
        with torch.no_grad():
            f_new = fun(z + t * direction)
        tries = 0
        while tries < max_linesearch and not (
            bool(torch.isfinite(f_new)) and bool(f_new <= f + c1 * t * dg)
        ):
            t = t * 0.5
            with torch.no_grad():
                f_new = fun(z + t * direction)
            tries += 1
        ls_failed = not (bool(torch.isfinite(f_new)) and bool(f_new <= f + c1 * t * dg))

        if ls_failed:
            z_new, f_new2, g_new = z, f, g
        else:
            z_new = z + t * direction
            f_new2, g_new = _value_and_grad(fun, z_new)

        s = z_new - z
        y = g_new - g
        sy = torch.dot(s, y)
        if sy > 1e-10 * torch.linalg.norm(s) * torch.linalg.norm(y):
            S.append(s)
            Y.append(y)
            rho.append(1.0 / sy)
            if len(S) > memory:
                S.pop(0), Y.pop(0), rho.pop(0)

        done = (
            bool(torch.max(torch.abs(g_new)) <= gtol)
            or bool(torch.abs(f_new2 - f) <= ftol * (1.0 + torch.abs(f)))
            or ls_failed
        )
        z, f, g = z_new, f_new2, g_new
        it += 1

    if not (bool(torch.isfinite(f)) and bool(torch.isfinite(z).all())):
        z, f = z0, f0
    return z, f, it, f0
