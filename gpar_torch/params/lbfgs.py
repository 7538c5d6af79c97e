"""Compact L-BFGS with its state on the device: the two-loop recursion over
a fixed-size circular history plus Armijo backtracking.

Port of ``gpar_tpu/params/lbfgs.py`` with the same trajectory: the same
two-loop recursion with circular-buffer masks and initial Hessian scaling,
the same conservative first step while no curvature pair is stored (``t0``
computed on the device), Armijo backtracking by halving (at most
``max_linesearch`` trials; a non-finite trial value shrinks the step like a
failed test), the ``s.y <= 1e-10 |s||y|`` skip guard, the same convergence
tests and the non-finite end-state guard.  ``torch.optim.LBFGS`` follows a
different trajectory and is not used.

The state (:class:`LBFGSState`: ``S``/``Y`` of shape (M, d), ``rho``,
``head``, ``count``, ``it``, ``done``) lives in fixed-shape device buffers
of :class:`DeviceLBFGS`, whose bodies do one iteration's device work
without reading anything back:

- ``step``: the direction, the first trial step ``t0``, value and gradient
  at the trial point, the Armijo and convergence tests, and the candidate
  next state (written beside the state, not over it);
- ``trial``: halve ``t`` and evaluate the value there (backtracking);
- ``commit``: the candidate becomes the state.

JAX evaluates the value at ``t0`` and then value and gradient at the
accepted point; Armijo accepts the first trial in most iterations, and then
that is the same point, so ``step`` evaluates value and gradient once
there.  :func:`iterate` drives one iteration from the host with one read of
a two-entry flags tensor after ``step`` (and one after each backtracking
trial and episode).  The bodies are plain functions of the buffers: the
same code runs eagerly or replays as CUDA graphs (``models/fused.py``,
``models/graphs.py``).
"""

from typing import NamedTuple

import torch

__all__ = [
    "MAX_LINESEARCH",
    "LBFGSState",
    "DeviceLBFGS",
    "two_loop",
    "iterate",
    "read_flags",
    "new_stats",
    "lbfgs_minimize",
]


#: Backtracking trials per iteration (the JAX package's default).
MAX_LINESEARCH = 25


class LBFGSState(NamedTuple):
    z: torch.Tensor  # current iterate (d,)
    f: torch.Tensor  # current value ()
    g: torch.Tensor  # current gradient (d,)
    S: torch.Tensor  # history of steps (M, d)
    Y: torch.Tensor  # history of gradient differences (M, d)
    rho: torch.Tensor  # 1 / (s . y) per slot (M,)
    head: torch.Tensor  # next write slot () int64
    count: torch.Tensor  # filled slots () int64
    it: torch.Tensor  # iteration counter () int64
    done: torch.Tensor  # convergence flag () bool


def _zero_state(d, memory, dtype, device):
    def f(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def i():
        return torch.zeros((), dtype=torch.int64, device=device)

    done = torch.zeros((), dtype=torch.bool, device=device)
    return LBFGSState(f(d), f(), f(d), f(memory, d), f(memory, d), f(memory), i(), i(), i(), done)


def two_loop(g, S, Y, rho, head, count):
    """Standard two-loop recursion over the circular history, unfilled
    slots masked out; returns the descent direction."""
    M = S.shape[0]
    ar = torch.arange(M, device=g.device)
    valid = ar < count
    newest = (head - 1 - ar) % M  # slot of the i-th newest pair
    Sn, Yn, rn = S.index_select(0, newest), Y.index_select(0, newest), rho.index_select(0, newest)
    q, alphas = g, []
    for i in range(M):
        a = torch.where(valid[i], rn[i] * torch.dot(Sn[i], q), 0.0)
        q = q - a * Yn[i] * valid[i]
        alphas.append(a)

    # Initial Hessian scaling gamma = (s.y) / (y.y) of the newest pair.
    yy = torch.dot(Yn[0], Yn[0])
    gamma = torch.where((count > 0) & (yy > 0), 1.0 / (torch.clamp_min(rn[0], 1e-300) * yy), 1.0)
    r = gamma * q

    alpha_slot = torch.zeros_like(rho).index_copy(0, newest, torch.stack(alphas))
    oldest = (head - count + ar) % M  # oldest to newest
    So, Yo = S.index_select(0, oldest), Y.index_select(0, oldest)
    ro, ao = rho.index_select(0, oldest), alpha_slot.index_select(0, oldest)
    for i in range(M):
        b = torch.where(valid[i], ro[i] * torch.dot(Yo[i], r), 0.0)
        r = r + So[i] * (ao[i] - b) * valid[i]
    return -r


def _direction(st):
    """Descent direction, its slope and the first trial step."""
    d = two_loop(st.g, st.S, st.Y, st.rho, st.head, st.count)
    dg = torch.dot(d, st.g)
    # Steepest descent if the direction is not a descent direction.
    bad = ~torch.isfinite(dg) | (dg >= 0)
    d = torch.where(bad, -st.g, d)
    dg = torch.where(bad, -torch.dot(st.g, st.g), dg)
    # First iteration: conservative initial step.
    t0 = torch.where(
        st.count == 0,
        torch.clamp_max(1.0 / torch.clamp_min(torch.sum(torch.abs(st.g)), 1e-12), 1.0),
        torch.ones_like(dg),
    )
    return d, dg, t0


def _armijo(f, f_t, t, dg, c1):
    return torch.isfinite(f_t) & (f_t <= f + c1 * t * dg)


def _advance(st, z_new, f_new, g_new, failed, gtol, ftol):
    """Curvature update and convergence tests: the next state."""
    M = st.S.shape[0]
    s = z_new - st.z
    y = g_new - st.g
    sy = torch.dot(s, y)
    good = sy > 1e-10 * torch.linalg.norm(s) * torch.linalg.norm(y)
    slot = st.head.reshape(1)
    S = torch.where(good, st.S.index_copy(0, slot, s[None]), st.S)
    Y = torch.where(good, st.Y.index_copy(0, slot, y[None]), st.Y)
    rho = torch.where(good, st.rho.index_copy(0, slot, (1.0 / sy).reshape(1)), st.rho)
    head = torch.where(good, (st.head + 1) % M, st.head)
    count = torch.where(good, torch.clamp_max(st.count + 1, M), st.count)
    done = (
        (torch.max(torch.abs(g_new)) <= gtol)
        | (torch.abs(f_new - st.f) <= ftol * (1.0 + torch.abs(st.f)))
        | failed
    )
    return LBFGSState(z_new, f_new, g_new, S, Y, rho, head, count, st.it + 1, done)


class DeviceLBFGS:
    """Fixed-shape L-BFGS buffers and the bodies of one iteration.

    ``value_and_grad(z) -> (f, g)`` and ``value(z) -> f`` evaluate the
    objective at a (d,) point.  Every body reports in ``flags = [accepted,
    done]``.  ``mode`` tells ``step`` what to evaluate: 0 the first trial
    at ``t0``, 1 the point backtracking accepted at ``t``, 2 none (the line
    search failed)."""

    def __init__(self, value_and_grad, value, d, dtype, device, memory=10,
                 gtol=1e-9, ftol=1e-12, c1=1e-4):
        self.value_and_grad, self.value = value_and_grad, value
        self.gtol, self.ftol, self.c1 = gtol, ftol, c1
        self.state = _zero_state(d, memory, dtype, device)
        self.cand = _zero_state(d, memory, dtype, device)
        self.z0 = torch.zeros(d, dtype=dtype, device=device)
        self.f0 = torch.zeros((), dtype=dtype, device=device)
        self.direction = torch.zeros(d, dtype=dtype, device=device)
        self.dg = torch.zeros((), dtype=dtype, device=device)
        self.t = torch.zeros((), dtype=dtype, device=device)
        self.mode = torch.zeros((), dtype=torch.int64, device=device)
        self.flags = torch.zeros(2, dtype=torch.int64, device=device)

    def _flags(self, ok, done):
        self.flags.copy_(torch.stack([ok, done]).to(torch.int64))

    def start(self, z0):
        """Body: value and gradient at ``z0``; an empty history."""
        f, g = self.value_and_grad(z0)
        st = self.state
        for buf, v in ((st.z, z0), (st.f, f), (st.g, g), (self.z0, z0), (self.f0, f)):
            buf.copy_(v)
        for buf in (st.S, st.Y, st.rho, st.head, st.count, st.it, st.done):
            buf.zero_()

    def step(self):
        """Body: evaluate the point ``mode`` names and write the candidate
        state, the direction, its slope and ``t``."""
        st = self.state
        d_new, dg_new, t0 = _direction(st)
        first = self.mode == 0
        direction = torch.where(first, d_new, self.direction)
        dg = torch.where(first, dg_new, self.dg)
        t = torch.where(first, t0, self.t)
        failed = self.mode == 2
        z_new = torch.where(failed, st.z, st.z + t * direction)
        f_new, g_new = self.value_and_grad(z_new)
        f_new = torch.where(failed, st.f, f_new)
        g_new = torch.where(failed, st.g, g_new)
        accepted = ~first | _armijo(st.f, f_new, t, dg, self.c1)
        for buf, v in zip(self.cand, _advance(st, z_new, f_new, g_new, failed, self.gtol, self.ftol)):
            buf.copy_(v)
        self.direction.copy_(direction)
        self.dg.copy_(dg)
        self.t.copy_(t)
        self._flags(accepted, self.cand.done)

    def trial(self):
        """Body: one backtracking trial, ``t <- t / 2`` and the value at
        ``z + t d``; ``flags[0]`` is its Armijo test."""
        self.t.mul_(0.5)
        st = self.state
        f_t = self.value(st.z + self.t * self.direction)
        self._flags(_armijo(st.f, f_t, self.t, self.dg, self.c1), st.done)

    def commit(self):
        """Body: the candidate becomes the state."""
        for buf, v in zip(self.state, self.cand):
            buf.copy_(v)

    def final(self):
        """``(z, f)``, guarded against a non-finite end state (then the
        start)."""
        st = self.state
        ok = torch.isfinite(st.f) & torch.all(torch.isfinite(st.z))
        return torch.where(ok, st.z, self.z0), torch.where(ok, st.f, self.f0)


def new_stats():
    """Counters of one run: host reads, backtracking episodes and trials."""
    return {"host_syncs": 0, "linesearch_episodes": 0, "linesearch_trials": 0}


def read_flags(flags, stats):
    """The one host read: ``flags`` as Python ints."""
    stats["host_syncs"] += 1
    return flags.tolist()


def iterate(run, opt, max_linesearch, stats):
    """One L-BFGS iteration of ``opt`` (a :class:`DeviceLBFGS`) driven from
    the host; ``run(name)`` runs its body ``name`` ("step", "trial",
    "commit"), eagerly or from a captured graph.

    One read after the first trial; when Armijo rejects it, one per
    backtracking trial and one after the accepted point's evaluation.
    The candidate state is committed only after its flags are read.
    Returns whether the optimiser has converged."""
    opt.mode.fill_(0)
    run("step")
    accepted, done = read_flags(opt.flags, stats)
    if not accepted:
        stats["linesearch_episodes"] += 1
        ok = 0
        for _ in range(max_linesearch):
            run("trial")
            stats["linesearch_trials"] += 1
            ok, _ = read_flags(opt.flags, stats)
            if ok:
                break
        opt.mode.fill_(1 if ok else 2)
        run("step")
        _, done = read_flags(opt.flags, stats)
    run("commit")
    return bool(done)


def lbfgs_minimize(
    fun,
    z0,
    iters=1000,
    gtol=1e-9,
    ftol=1e-12,
    memory=10,
    max_linesearch=MAX_LINESEARCH,
    c1=1e-4,
    stats=None,
):
    """Minimise ``fun`` from ``z0``, eagerly; returns ``(z, f,
    iterations_used, f0)`` with ``f0`` the objective at ``z0``.  ``stats``
    (a :func:`new_stats` dict) receives the run's counters."""
    z0 = z0.detach()

    def value_and_grad(z):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(z)
            (g,) = torch.autograd.grad(f, z)
        return f.detach(), g

    def value(z):
        with torch.no_grad():
            return fun(z)

    stats = new_stats() if stats is None else stats
    opt = DeviceLBFGS(value_and_grad, value, z0.shape[0], z0.dtype, z0.device,
                      memory=memory, gtol=gtol, ftol=ftol, c1=c1)
    opt.start(z0)

    def run(name):
        getattr(opt, name)()

    it = 0
    while it < iters:
        done = iterate(run, opt, max_linesearch, stats)
        it += 1
        if done:
            break
    z, f = opt.final()
    return z, f, it, opt.f0.clone()
