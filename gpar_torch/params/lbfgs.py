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
``models/graphs.py``).  An optimiser given a ``status`` (an int64 device
tensor that the objective's owner keeps and the optimiser never reads)
writes it into a third entry of the flags, so that it comes back in the
same read: :func:`iterate` ends an iteration at a read that finds it
other than 0, commits nothing, and hands the value back.

:class:`BatchedDeviceLBFGS` runs B independent optimisations at once (the
JAX package's ``vmap`` of ``lbfgs_minimize`` over restarts and layers,
``gpar_tpu/params/optim.py:44-80``): the objective evaluates a (B, d)
batch of points to (B,) values, and every element follows the trajectory
it would follow alone, as under JAX's vmapped ``while_loop``s: its own
``t0``, Armijo tests, backtracking and iteration count, and once it is done
it is frozen.  The host reads the (B, 2) flags once per iteration and once
per round of backtracking trials; a round halves ``t`` only for the
elements still searching, and the re-evaluation after the search leaves
the candidates of the elements that accepted their first trial alone.
:func:`lbfgs_minimize_restarts` is the multi-start driver on top of it.
"""

from typing import NamedTuple

import torch

from ..utils.spans import span

__all__ = [
    "MAX_LINESEARCH",
    "LBFGSState",
    "DeviceLBFGS",
    "BatchedDeviceLBFGS",
    "two_loop",
    "iterate",
    "read_flags",
    "new_stats",
    "lbfgs_minimize",
    "lbfgs_minimize_batched",
    "lbfgs_minimize_restarts",
    "best_of",
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
    search failed).  With ``status`` (an int64 device tensor of the
    objective's owner) the flags are ``[accepted, done, status]``."""

    def __init__(self, value_and_grad, value, d, dtype, device, memory=10,
                 gtol=1e-9, ftol=1e-12, c1=1e-4, status=None):
        self.value_and_grad, self.value = value_and_grad, value
        self.status = status
        self.gtol, self.ftol, self.c1 = gtol, ftol, c1
        self.state = _zero_state(d, memory, dtype, device)
        self.cand = _zero_state(d, memory, dtype, device)
        self.z0 = torch.zeros(d, dtype=dtype, device=device)
        self.f0 = torch.zeros((), dtype=dtype, device=device)
        self.direction = torch.zeros(d, dtype=dtype, device=device)
        self.dg = torch.zeros((), dtype=dtype, device=device)
        self.t = torch.zeros((), dtype=dtype, device=device)
        self.mode = torch.zeros((), dtype=torch.int64, device=device)
        self.flags = torch.zeros(2 if status is None else 3, dtype=torch.int64, device=device)

    def _flags(self, ok, done):
        flags = torch.stack([ok, done]).to(torch.int64)
        if self.status is not None:
            flags = torch.cat([flags, self.status.reshape(1)])
        self.flags.copy_(flags)

    def buffers(self):
        """Every buffer, in a fixed order."""
        return [*self.state, *self.cand, self.z0, self.f0, self.direction, self.dg, self.t,
                self.mode, self.flags]

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


# -- the batch --------------------------------------------------------------------


def _bdot(a, b):
    return torch.sum(a * b, dim=-1)


def _two_loop_batched(g, S, Y, rho, head, count):
    """:func:`two_loop` per element: ``g`` (B, d), ``S``/``Y`` (B, M, d),
    ``rho`` (B, M), ``head``/``count`` (B,)."""
    M, d = S.shape[1], S.shape[2]
    ar = torch.arange(M, device=g.device)
    valid = ar[None, :] < count[:, None]  # (B, M)

    def take(A, slots):
        return A.gather(1, slots[..., None].expand(-1, -1, d))

    newest = (head[:, None] - 1 - ar[None, :]) % M
    Sn, Yn, rn = take(S, newest), take(Y, newest), rho.gather(1, newest)
    q, alphas = g, []
    for i in range(M):
        a = torch.where(valid[:, i], rn[:, i] * _bdot(Sn[:, i], q), 0.0)
        q = q - a[:, None] * Yn[:, i] * valid[:, i, None]
        alphas.append(a)
    yy = _bdot(Yn[:, 0], Yn[:, 0])
    gamma = torch.where((count > 0) & (yy > 0), 1.0 / (torch.clamp_min(rn[:, 0], 1e-300) * yy), 1.0)
    r = gamma[:, None] * q
    alpha_slot = torch.zeros_like(rho).scatter(1, newest, torch.stack(alphas, dim=1))
    oldest = (head[:, None] - count[:, None] + ar[None, :]) % M
    So, Yo = take(S, oldest), take(Y, oldest)
    ro, ao = rho.gather(1, oldest), alpha_slot.gather(1, oldest)
    for i in range(M):
        b = torch.where(valid[:, i], ro[:, i] * _bdot(Yo[:, i], r), 0.0)
        r = r + So[:, i] * ((ao[:, i] - b) * valid[:, i])[:, None]
    return -r


def _direction_batched(st):
    d = _two_loop_batched(st.g, st.S, st.Y, st.rho, st.head, st.count)
    dg = _bdot(d, st.g)
    bad = ~torch.isfinite(dg) | (dg >= 0)
    d = torch.where(bad[:, None], -st.g, d)
    dg = torch.where(bad, -_bdot(st.g, st.g), dg)
    t0 = torch.where(
        st.count == 0,
        torch.clamp_max(1.0 / torch.clamp_min(torch.sum(torch.abs(st.g), dim=-1), 1e-12), 1.0),
        torch.ones_like(dg),
    )
    return d, dg, t0


def _advance_batched(st, z_new, f_new, g_new, failed, gtol, ftol):
    M, d = st.S.shape[1], st.S.shape[2]
    s = z_new - st.z
    y = g_new - st.g
    sy = _bdot(s, y)
    good = sy > 1e-10 * torch.linalg.vector_norm(s, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
    slot = st.head[:, None, None].expand(-1, 1, d)
    keep = good[:, None, None]
    S = torch.where(keep, st.S.scatter(1, slot, s[:, None]), st.S)
    Y = torch.where(keep, st.Y.scatter(1, slot, y[:, None]), st.Y)
    rho = torch.where(good[:, None], st.rho.scatter(1, st.head[:, None], (1.0 / sy)[:, None]),
                      st.rho)
    head = torch.where(good, (st.head + 1) % M, st.head)
    count = torch.where(good, torch.clamp_max(st.count + 1, M), st.count)
    done = (
        (torch.amax(torch.abs(g_new), dim=-1) <= gtol)
        | (torch.abs(f_new - st.f) <= ftol * (1.0 + torch.abs(st.f)))
        | failed
    )
    return LBFGSState(z_new, f_new, g_new, S, Y, rho, head, count, st.it + 1, done)


def _rows(mask, like):
    """A (B,) mask against ``like`` (B, ...)."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


class BatchedDeviceLBFGS:
    """B independent L-BFGS runs in one set of (B, ...) buffers, with the
    bodies and the host protocol of :class:`DeviceLBFGS`.

    ``value_and_grad(z) -> (f, g)`` and ``value(z) -> f`` evaluate a (B, d)
    batch of points.  ``flags`` is (B, 2), per element ``[accepted, done]``;
    an element that is done reports both.  ``mode`` is 0 for an
    iteration's first trial and anything else for the evaluation after a
    search; which elements searched (``needs_ls``) and which are still
    searching, so failed, (``searching``) is kept on the device.  With
    ``status`` every row of the flags carries it, (B, 3), as in
    :class:`DeviceLBFGS`."""

    def __init__(self, value_and_grad, value, batch, d, dtype, device, memory=10,
                 gtol=1e-9, ftol=1e-12, c1=1e-4, status=None):
        self.value_and_grad, self.value = value_and_grad, value
        self.status = status
        self.gtol, self.ftol, self.c1 = gtol, ftol, c1
        B = batch

        def state():
            def f(*shape):
                return torch.zeros((B, *shape), dtype=dtype, device=device)

            def i():
                return torch.zeros(B, dtype=torch.int64, device=device)

            return LBFGSState(f(d), f(), f(d), f(memory, d), f(memory, d), f(memory), i(), i(),
                              i(), torch.zeros(B, dtype=torch.bool, device=device))

        self.state, self.cand = state(), state()
        self.z0 = torch.zeros((B, d), dtype=dtype, device=device)
        self.f0 = torch.zeros(B, dtype=dtype, device=device)
        self.direction = torch.zeros((B, d), dtype=dtype, device=device)
        self.dg = torch.zeros(B, dtype=dtype, device=device)
        self.t = torch.zeros(B, dtype=dtype, device=device)
        self.needs_ls = torch.zeros(B, dtype=torch.bool, device=device)
        self.searching = torch.zeros(B, dtype=torch.bool, device=device)
        self.mode = torch.zeros((), dtype=torch.int64, device=device)
        self.flags = torch.zeros((B, 2 if status is None else 3), dtype=torch.int64,
                                 device=device)

    def buffers(self):
        return [*self.state, *self.cand, self.z0, self.f0, self.direction, self.dg, self.t,
                self.needs_ls, self.searching, self.mode, self.flags]

    def _flags(self, ok, done):
        flags = torch.stack([ok, done], dim=1).to(torch.int64)
        if self.status is not None:
            flags = torch.cat([flags, self.status.expand(flags.shape[0], 1)], dim=1)
        self.flags.copy_(flags)

    def start(self, z0):
        """Body: value and gradient at ``z0`` (B, d); empty histories."""
        f, g = self.value_and_grad(z0)
        st = self.state
        for buf, v in ((st.z, z0), (st.f, f), (st.g, g), (self.z0, z0), (self.f0, f)):
            buf.copy_(v)
        for buf in (st.S, st.Y, st.rho, st.head, st.count, st.it, st.done):
            buf.zero_()

    def step(self):
        """Body: at ``mode`` 0 every element's first trial at ``t0``; else
        the point each searching element's backtracking accepted (its
        current point if the search failed), the candidates of the others
        kept.  Writes the candidate states and the flags."""
        st = self.state
        active = ~st.done
        d_new, dg_new, t0 = _direction_batched(st)
        first = self.mode == 0
        direction = torch.where(first, d_new, self.direction)
        dg = torch.where(first, dg_new, self.dg)
        t = torch.where(first, t0, self.t)
        failed = ~first & self.needs_ls & self.searching
        z_new = torch.where(failed[:, None], st.z, st.z + t[:, None] * direction)
        f_new, g_new = self.value_and_grad(z_new)
        f_new = torch.where(failed, st.f, f_new)
        g_new = torch.where(failed[:, None], st.g, g_new)
        cand = _advance_batched(st, z_new, f_new, g_new, failed, self.gtol, self.ftol)
        # After a search, only the elements that searched take the new point.
        take = first | self.needs_ls
        for buf, v in zip(self.cand, cand):
            buf.copy_(torch.where(_rows(take, v), v, buf))
        needs = torch.where(first, active & ~_armijo(st.f, f_new, t, dg, self.c1), self.needs_ls)
        self.needs_ls.copy_(needs)
        self.searching.copy_(torch.where(first, needs, self.searching))
        self.direction.copy_(direction)
        self.dg.copy_(dg)
        self.t.copy_(t)
        self._flags(~needs | ~first, ~active | self.cand.done)

    def trial(self):
        """Body: one round of backtracking, ``t <- t / 2`` and the value at
        ``z + t d`` for the elements still searching; ``flags[:, 0]`` says
        which are not."""
        st = self.state
        self.t.copy_(torch.where(self.searching, 0.5 * self.t, self.t))
        f_t = self.value(st.z + self.t[:, None] * self.direction)
        self.searching.copy_(self.searching & ~_armijo(st.f, f_t, self.t, self.dg, self.c1))
        self._flags(~self.searching, st.done)

    def commit(self):
        """Body: the candidates become the states of the elements that
        were not done."""
        active = ~self.state.done
        for buf, v in zip(self.state, self.cand):
            buf.copy_(torch.where(_rows(active, v), v, buf))

    def final(self):
        """``(z, f)`` per element, each guarded against a non-finite end
        state (then its start)."""
        st = self.state
        ok = torch.isfinite(st.f) & torch.all(torch.isfinite(st.z), dim=-1)
        return torch.where(ok[:, None], st.z, self.z0), torch.where(ok, st.f, self.f0)


def new_stats():
    """Counters of one run: host reads, backtracking episodes and trials."""
    return {"host_syncs": 0, "linesearch_episodes": 0, "linesearch_trials": 0}


def read_flags(flags, stats):
    """The one host read: ``flags`` as Python ints, ``(accepted, done,
    status)`` (of a batch: whether every element accepted, whether every
    element is done), under the span ``gpar.fit.read``; ``status`` the value
    of the optimiser's status tensor, 0 without one."""
    stats["host_syncs"] += 1
    with span("gpar.fit.read"):
        out = flags.tolist()
    rows = out if flags.ndim == 2 else [out]
    return all(r[0] for r in rows), all(r[1] for r in rows), rows[0][2] if len(rows[0]) > 2 else 0


def iterate(run, opt, max_linesearch, stats):
    """One L-BFGS iteration of ``opt`` (a :class:`DeviceLBFGS`) driven from
    the host; ``run(name)`` runs its body ``name`` ("step", "trial",
    "commit"), eagerly or from a captured graph.

    One read after the first trial; when Armijo rejects it, one per
    backtracking trial and one after the accepted point's evaluation.
    The candidate state is committed only after its flags are read.
    Returns ``(done, status)``: whether the optimiser has converged (a
    batch: every element), and 0; or, where a read finds a status other
    than 0 (:func:`read_flags`), ``(False, status)`` at once, the iteration
    ended there and nothing committed.
    """
    opt.mode.fill_(0)
    run("step")
    accepted, done, status = read_flags(opt.flags, stats)
    if status:
        return False, status
    if not accepted:
        stats["linesearch_episodes"] += 1
        ok = 0
        for _ in range(max_linesearch):
            run("trial")
            stats["linesearch_trials"] += 1
            ok, _, status = read_flags(opt.flags, stats)
            if status:
                return False, status
            if ok:
                break
        opt.mode.fill_(1 if ok else 2)
        run("step")
        _, done, status = read_flags(opt.flags, stats)
        if status:
            return False, status
    run("commit")
    return bool(done), 0


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
        done, _ = iterate(run, opt, max_linesearch, stats)
        it += 1
        if done:
            break
    z, f = opt.final()
    return z, f, it, opt.f0.clone()


def _objective(fun):
    def value_and_grad(z):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(z)
            (g,) = torch.autograd.grad(f.sum(), z)
        return f.detach(), g

    def value(z):
        with torch.no_grad():
            return fun(z)

    return value_and_grad, value


def lbfgs_minimize_batched(
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
    """B independent minimisations at once, eagerly: ``fun`` maps a (B, d)
    batch of points to (B,) values, each element's value depending on its
    own point only; ``z0`` is (B, d).  Returns ``(z, f, its, f0)`` per
    element, (B, d), (B,), (B,) and (B,): each what :func:`lbfgs_minimize`
    returns for that element alone, to rounding."""
    z0 = z0.detach()
    stats = new_stats() if stats is None else stats
    value_and_grad, value = _objective(fun)
    opt = BatchedDeviceLBFGS(value_and_grad, value, z0.shape[0], z0.shape[1], z0.dtype,
                             z0.device, memory=memory, gtol=gtol, ftol=ftol, c1=c1)
    opt.start(z0)

    def run(name):
        getattr(opt, name)()

    for _ in range(iters):
        if iterate(run, opt, max_linesearch, stats)[0]:
            break
    z, f = opt.final()
    return z, f, opt.state.it.clone(), opt.f0.clone()


def best_of(f):
    """Index of the best finite value of ``f`` (B,), on the device (the
    first of equals, as ``jnp.argmin``)."""
    return torch.argmin(torch.where(torch.isfinite(f), f, torch.inf)).reshape(1)


def lbfgs_minimize_restarts(fun, z0, normals, restart_scale=1.0, **kwargs):
    """Multi-start L-BFGS, the counterpart of ``lbfgs_traced_restarts``
    (``gpar_tpu/params/optim.py:44-80``): one unperturbed start ``z0`` (d,)
    and ``R - 1`` starts ``z0 + restart_scale * normals`` (``normals`` (R - 1,
    d)), run as one batch (:func:`lbfgs_minimize_batched`; ``fun`` maps
    (R, d) to (R,)).  Returns ``(z, f, iterations, f0)`` of the best finite
    optimum, chosen on the device, with ``f0`` the unperturbed start's
    value."""
    z0 = z0.detach()
    starts = torch.cat([z0[None], z0[None] + restart_scale * normals.to(z0)])
    z, f, its, f0 = lbfgs_minimize_batched(fun, starts, **kwargs)
    best = best_of(f)
    return z.index_select(0, best)[0], f.index_select(0, best)[0], its.index_select(0, best)[0], f0[0]
