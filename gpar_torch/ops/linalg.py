"""Dense linear algebra for the GP core.

Port of ``gpar_tpu/ops/linalg.py``: jittered Cholesky factorisations,
sampling factors, triangular solves, MVN log-densities and the collapsed
Titsias (2009) ELBO with per-point noise (reference call sites
``gpar/model.py:226,286-289``).

Factorisations are ``torch.linalg.cholesky_ex`` (cuSOLVER on the card).
The JAX package's blocked Cholesky is a TPU panel schedule, not a Pallas
kernel, and the JAX package itself leaves the factor to XLA off-TPU; it
has no counterpart here.

**The jitter rule.**  This module alone decides which jitter a
factorisation takes; every caller asks it, through a :class:`Jitter` or
through :func:`safe_cholesky` and the sampling factors.  Each starts from
one primitive, :func:`cholesky_at`, ``(L, info)`` of ``cholesky_ex(K + e
I)``.  The rungs are ``eps`` (:func:`resolve_epsilon`), ``eps`` times each
of ``config.cholesky_retry_factors``, and last the relative jitter ``max(1e-6
max|diag K|, eps)``.  A failed factor is finite garbage, so ``info``, not
``isfinite``, says whether a rung held.  A :class:`Jitter` follows one of
three rules:

- ``"host"`` (:data:`HOST`, the default of every function that takes a
  rule; :func:`safe_cholesky`): read ``info`` back after each rung and try
  the next only where it failed, one host sync a rung tried.  A failed rung
  never enters the autograd graph, so the JAX package's NaN-proof Cholesky
  VJP (``_chol_grad_safe``) is not needed: the gradient is that of the rung
  that held.
- ``"device"``: no host read, so a CUDA graph can hold it.  Every rung is
  tried on the device without autograd, the first that holds is chosen by
  ``torch.where``, and the matrix is factored once more at that rung's
  jitter, with autograd: value and gradient bit for bit the host ladder's
  (the same factorisation of the same matrix; the unchosen rungs add exact
  zeros), at the price of the probes.  The JAX counterpart is the ladder
  through ``lax.cond`` (``gpar_tpu/ops/linalg.py:337-380``).
- ``"first_rung"``: one factorisation, at the first rung, with autograd and
  no host read.  Where it holds it is the ladder's factor and gradient bit
  for bit; where it fails the factor is NaN.

Every rule gives NaN where no rung holds (the JAX package's NaN primal).
The two device rules count into the rule's own int64 device tensor,
``count``: the factorisations that needed more than the first rung, or
whose first rung failed.  :meth:`Jitter.read` brings a caller's results and
that count back in one read.

**Replay, read once, repair eagerly.**  A CUDA graph replays the first
rung; the caller reads its failures once after the replay, with what it
reads anyway, and where there is one runs that work again eagerly on a
ladder.  The scan fit does so per layer (its L-BFGS flags carry the
``"first_rung"`` count; ``models.fused.run_scan_fit``), and the two
predictive tails in one read a call (``models.fused.run_tail``): the
cached tail per layer's sampling factor (:func:`cholesky_at`'s ``info``),
the uncached tail, whose graph factors every layer's training covariance
under ``"first_rung"`` and its sampling factor by :func:`cholesky_at`, for
the whole tail (the count and the flags together; a failure runs the whole
eager tail again).  The answer is
the ladder's in every case.

The sampling factors (:func:`psd_sample_factor_batched`) take the host
ladder, and a clamped eigendecomposition where no rung holds.

The device rules, the solves and the Titsias factors take a leading batch
axis (the JAX package vmaps its fits' objectives over restarts and
layers): every reduction runs over each element's own axes, and a ladder
picks its rung per element, as JAX's vmapped ``lax.cond`` does, so one
element's failing factorisation never changes another's jitter.  A single
matrix is never given a batch axis.
"""

import torch

from ..config import config

__all__ = [
    "LOG_2PI",
    "BATCHED_CHOLESKY_MAX_N",
    "resolve_epsilon",
    "jitter_key",
    "floor_noise",
    "add_jitter",
    "cholesky_at",
    "Jitter",
    "HOST",
    "safe_cholesky",
    "psd_sample_factor",
    "psd_sample_factor_batched",
    "counters",
    "reset_counters",
    "matvec",
    "solve_lower",
    "solve_chol",
    "mvn_logpdf_chol",
    "mvn_logpdf",
    "titsias_elbo",
    "titsias_factors",
    "titsias_solve",
    "titsias_assemble",
]

LOG_2PI = 1.8378770664093453  # log(2 * pi)

#: Counters of :func:`psd_sample_factor_batched`, kept by the host from the
#: reads of ``info`` it makes anyway (no read of their own):
#: ``sample_factor_batches`` its calls, ``sample_factor_rungs`` the rungs
#: it read, ``sample_factor_escalations`` the elements that needed a rung
#: past the first and ``sample_factor_eigh`` those that no rung repaired
#: (the clamped eigendecomposition).  A CUDA graph's first rung counts in
#: none of them.
_COUNTS = dict.fromkeys(("sample_factor_batches", "sample_factor_rungs",
                         "sample_factor_escalations", "sample_factor_eigh"), 0)


def counters():
    """The sampling factor's counters by name."""
    return dict(_COUNTS)


def reset_counters():
    _COUNTS.update(dict.fromkeys(_COUNTS, 0))


def resolve_epsilon(dtype, epsilon=None):
    """Effective Cholesky jitter for ``dtype``: an explicit ``epsilon``
    wins; otherwise ``config.epsilon``, floored at ``config.epsilon_f32``
    for float32 (``examples/paper/air_temp.py:18``)."""
    if epsilon is not None:
        return epsilon
    eps = config.epsilon
    if dtype == torch.float32:
        eps = max(eps, config.epsilon_f32)
    return eps


def jitter_key():
    """The settings the jitter rule reads, for the keys of work that bakes
    them in (the graph cache, the posterior-factor slot)."""
    return config.epsilon, config.epsilon_f32, tuple(config.cholesky_retry_factors)


def floor_noise(noise_diag):
    """Per-point noise variances floored at the dtype's jitter epsilon: a
    float64 no-op, 1e-6 in float32, where the reference's 1e-8 noise bound
    is below working resolution and the Titsias terms scaling as 1/noise
    would otherwise cancel catastrophically."""
    return torch.clamp_min(noise_diag, resolve_epsilon(noise_diag.dtype))


def add_jitter(K, epsilon=None):
    """Add ``epsilon`` to the diagonal of a square matrix."""
    eps = resolve_epsilon(K.dtype, epsilon)
    return K + eps * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


#: Order above which the fit's ladders factor a batch of CUDA matrices one
#: matrix at a time: cuSOLVER's batched ``potrf`` (which ``cholesky_ex``
#: takes for any batch) is made for small matrices, and two dense restarts
#: at 11 840 rows took 4.4 times one restart's fit through it on an H100
#: (PERF.md §6, PR 9).  Each element then gets the factor the unbatched
#: route computes.  The sampling factors keep one batched call at every size.
BATCHED_CHOLESKY_MAX_N = 512


def cholesky_at(K, e, split=True):
    """``(L, info)`` of ``cholesky_ex(K + e I)``, the factorisation every
    rule and the sampling factors start from: ``e`` a number, or a tensor
    with one jitter per element of a batch ``K`` (B, n, n).  With ``split``
    a batch of CUDA matrices of order over :data:`BATCHED_CHOLESKY_MAX_N`
    is factored one matrix at a time."""
    if isinstance(e, torch.Tensor) and e.ndim:
        e = e[..., None, None]
    A = K + e * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    if split and A.ndim > 2 and A.is_cuda and A.shape[-1] > BATCHED_CHOLESKY_MAX_N:
        parts = [torch.linalg.cholesky_ex(a) for a in A.reshape(-1, *A.shape[-2:])]
        return (torch.stack([L for L, _ in parts]).reshape(A.shape),
                torch.stack([i for _, i in parts]).reshape(A.shape[:-2]))
    return torch.linalg.cholesky_ex(A)


def _later_rungs(K, eps):
    """The rungs after the first: ``eps`` times each retry factor, then the
    relative jitter ``max(1e-6 max|diag K|, eps)`` of each element (with
    its gradient), computed when it is reached."""
    for factor in config.cholesky_retry_factors:
        yield eps * factor
    yield torch.clamp_min(1e-6 * torch.amax(torch.abs(torch.diagonal(K, dim1=-2, dim2=-1)), -1),
                          eps)


def _host_ladder(K, eps):
    """The host ladder of ``K`` (n, n) or (S, n, n): ``(L, bad, escalated,
    rungs)``.  The first rung factors all of ``K``; each later rung factors
    only the elements still failing, and the factors that hold are kept.
    ``info`` is read back once a rung tried (``rungs`` of them);
    ``escalated`` counts the elements the first rung failed, ``bad`` lists
    the indices of those every rung failed (of one matrix, ``[0]`` or
    ``[]``).  One batched ``cholesky_ex`` a rung at every size."""
    L, info = cholesky_at(K, eps, split=False)
    bad = [i for i, v in enumerate(info.reshape(-1).tolist()) if v]
    escalated, rungs = len(bad), 1
    for e in _later_rungs(K, eps):
        if not bad:
            break
        if K.ndim == 2:
            L, info = cholesky_at(K, e)
        else:
            Lb, info = cholesky_at(K[bad], e[bad] if isinstance(e, torch.Tensor) else e,
                                   split=False)
            L[bad] = Lb
        bad = [i for i, v in zip(bad, info.reshape(-1).tolist()) if v]
        rungs += 1
    return L, bad, escalated, rungs


class Jitter:
    """One of the module's three jitter rules for a caller's Cholesky
    factorisations: ``"host"`` (:data:`HOST`), ``"device"`` or
    ``"first_rung"``.  The two device rules hold ``count``, an int64 tensor
    on ``device``, zero to start."""

    RULES = ("host", "device", "first_rung")

    def __init__(self, rule="host", device=None):
        if rule not in self.RULES:
            raise ValueError(f"jitter rule {rule!r} is not one of {self.RULES}")
        self.rule = rule
        self.count = None if rule == "host" else torch.zeros((), dtype=torch.int64, device=device)

    def cholesky(self, K, epsilon=None):
        """The lower Cholesky factor of ``K`` plus the rule's jitter, NaN
        where no rung holds; ``K`` (n, n), or on a device rule (B, n, n)
        with every element its own rung and count."""
        eps = resolve_epsilon(K.dtype, epsilon)
        if K.shape[-1] == 0:
            return torch.zeros_like(K)
        if self.rule == "host":
            L, bad, _, _ = _host_ladder(K, eps)
            return torch.full_like(K, float("nan")) if bad else L
        if self.rule == "first_rung":
            L, info = cholesky_at(K, eps)
            bad = info != 0
            self.count.add_(torch.sum(bad).to(self.count.dtype))
            return torch.where(bad[..., None, None], float("nan"), L)
        rungs = [eps, *_later_rungs(K, eps)]
        with torch.no_grad():
            ok = [cholesky_at(K, e)[1] == 0 for e in rungs]
            self.count.add_(torch.sum(~ok[0]).to(self.count.dtype))
        e = rungs[-1]
        for r, held in zip(reversed(rungs[:-1]), reversed(ok[:-1])):
            e = torch.where(held, r, e)
        L, _ = cholesky_at(K, e)
        return torch.where(torch.stack(ok).any(0)[..., None, None], L, float("nan"))

    def read(self, out, *more):
        """``out`` (a device tensor) and ``count``, summed with the counts of
        the rules ``more`` (each on its own device), in one host read:
        ``(out as NumPy, count)``."""
        count = sum((j.count.to(self.count.device) for j in more), self.count)
        res = torch.cat([out.reshape(-1), count.to(out).reshape(1)]).cpu().numpy()
        return res[:-1].reshape(out.shape), int(res[-1])


#: The host ladder, the rule of every caller that names none.
HOST = Jitter()


def safe_cholesky(K, epsilon=None):
    """The jittered Cholesky factor of one matrix on the host ladder (the
    module's rule ``"host"``), NaN if every rung fails."""
    return HOST.cholesky(K, epsilon)


def psd_sample_factor(K, epsilon=None):
    """A finite factor ``F`` with ``F F^T ~= K`` for MVN sampling: the
    jittered Cholesky through the host ladder, or — when no rung repairs an
    indefinite matrix — an eigendecomposition with eigenvalues clamped at
    the jitter level."""
    return psd_sample_factor_batched(K[None], epsilon)[0]


def psd_sample_factor_batched(K, epsilon=None):
    """:func:`psd_sample_factor` over a leading batch axis, ``K`` (S, n, n)
    (``gpar_tpu/ops/linalg.py:409-467``): the host ladder, each later rung
    on the elements still failing only, and the clamped eigendecomposition
    only on those that every rung failed.  Factors that hold are kept.  One
    host read of ``info`` per rung tried, counted (:func:`counters`)."""
    eps = resolve_epsilon(K.dtype, epsilon)
    if K.shape[-1] == 0:
        return torch.zeros_like(K)
    L, bad, escalated, rungs = _host_ladder(K, eps)
    for name, n in (("batches", 1), ("rungs", rungs), ("escalations", escalated),
                    ("eigh", len(bad))):
        _COUNTS["sample_factor_" + name] += n
    if bad:
        w, V = torch.linalg.eigh(K[bad])
        L[bad] = V * torch.sqrt(torch.clamp_min(w, eps))[..., None, :]
    return L


def solve_lower(L, b):
    """Solve ``L x = b`` with ``L`` lower triangular (``b`` a vector or a
    matrix; with a batch of factors (B, n, n), (B, n) or (B, n, k))."""
    if L.shape[-1] == 0:
        return b
    if b.ndim == L.ndim - 1:
        return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]
    return torch.linalg.solve_triangular(L, b, upper=False)


def _solve_lower_t(L, b):
    """Solve ``L^T x = b`` with ``L`` lower triangular."""
    if b.ndim == L.ndim - 1:
        return torch.linalg.solve_triangular(L.mT, b[..., None], upper=True)[..., 0]
    return torch.linalg.solve_triangular(L.mT, b, upper=True)


def matvec(A, v):
    """``A @ v`` for a vector ``v``, or (B, k) vectors against (B, ., k)."""
    return A @ v if v.ndim == 1 else (A @ v[..., None])[..., 0]


def solve_chol(L, b):
    """Solve ``(L L^T) x = b`` given the Cholesky factor ``L``."""
    if L.shape[-1] == 0:
        return b
    return _solve_lower_t(L, solve_lower(L, b))


def mvn_logpdf_chol(y, mean, L):
    """Exact MVN log density given the Cholesky factor of the covariance
    (``tests/test_model.py:137-147``); ``y``/``mean`` are (n,) vectors."""
    n = y.shape[0]
    if n == 0:
        return y.new_zeros(())
    a = solve_lower(L, y - mean)
    return -0.5 * n * LOG_2PI - torch.sum(torch.log(torch.diagonal(L))) - 0.5 * torch.sum(a * a)


def mvn_logpdf(y, mean, K, epsilon=None):
    """Exact MVN log density with covariance ``K`` (jittered Cholesky)."""
    return mvn_logpdf_chol(y, mean, safe_cholesky(K, epsilon))


def titsias_elbo(Kmm, Kmn, knn_diag, y, mean, noise_diag, epsilon=None):
    """Collapsed Titsias (2009) ELBO with heteroscedastic noise,
    ``log N(y | mean, Q_nn + D) - 1/2 sum_i (K_nn - Q_nn)_ii / D_ii``."""
    if y.shape[0] == 0:
        return y.new_zeros(())
    return titsias_factors(Kmm, Kmn, knn_diag, y, mean, noise_diag, epsilon)[0]


def titsias_factors(Kmm, Kmn, knn_diag, y, mean, noise_diag, epsilon=None, mask=None,
                    jitter=HOST):
    """Collapsed Titsias ELBO and the sparse-posterior factors from one
    factorisation pass: ``(elbo, Lm, LB, beta)`` with ``Lm = chol(Kmm)``,
    ``LB = chol(I + Lm^{-1} Kmn D^{-1} Knm Lm^{-T})`` and
    ``beta = (Kmm + Kmn D^{-1} Knm)^{-1} Kmn D^{-1} r``.

    ``mask`` (optional (n,) of 0/1) excludes rows exactly: a masked row's
    ``D^{-1}`` is zero and its logdet/count contributions vanish.

    ``jitter``: the :class:`Jitter` rule of both factorisations (the
    module docstring).

    A batch: ``Kmm`` (B, m, m), ``Kmn`` (B, m, n), ``knn_diag`` and
    ``noise_diag`` (B, n); ``y``, ``mean`` and ``mask`` (n,) or (B, n).
    Every result then has the batch axis.

    The cancellation-free float32 form of the JAX package: ``A0 = Lm^{-1}
    Kmn`` stays at O(1) scale and both differences — the trace
    ``sum (knn - qnn) / D`` and the quadratic form ``sum r (r - est) / D``
    (Woodbury, ``est = Knm beta = A0^T w``) — are taken on O(1) operands
    before dividing by D.  The textbook form subtracts 1/D-scale
    quantities and returns hugely positive garbage at the float32 noise
    floor.  The Nystrom residual ``knn - qnn`` is clamped at zero: in
    float32 at extreme kernel variances it is pure cancellation noise of
    either sign, and a negative trace flips the ELBO positive.
    """
    r = y - mean
    if mask is None:
        d_inv = 1.0 / noise_diag
        logdet_d = torch.sum(torch.log(noise_diag), dim=-1)
        n_eff = y.shape[-1]
    else:
        r = r * mask
        d_inv = mask / noise_diag
        logdet_d = torch.sum(torch.log(noise_diag) * mask, dim=-1)
        n_eff = torch.sum(mask, dim=-1)

    Lm = jitter.cholesky(Kmm, epsilon)
    A0 = solve_lower(Lm, Kmn)  # (m, n), O(1) entries
    qnn = torch.sum(A0 * A0, dim=-2)
    trace_num = torch.sum(torch.clamp_min(knn_diag - qnn, 0.0) * d_inv, dim=-1)
    G = (A0 * d_inv[..., None, :]) @ A0.mT
    u = matvec(A0, r * d_inv)
    LB, w, beta = titsias_solve(G, u, Lm, jitter)
    est = matvec(A0.mT, w)
    quad = torch.sum(r * (r - est) * d_inv, dim=-1)
    elbo = titsias_assemble(logdet_d, LB, quad, trace_num, n_eff)
    return elbo, Lm, LB, beta


def titsias_solve(G, u, Lm, jitter=HOST):
    """The O(m^3) core of the collapsed ELBO: ``LB = chol(I + G)`` (jittered
    by the rule ``jitter``, as in :func:`titsias_factors` — in float32 near
    the noise floor ``I + G`` can be numerically indefinite), ``w = LB^{-T}
    LB^{-1} u`` and ``beta = Lm^{-T} w``.  ``G`` is resymmetrised first."""
    m = G.shape[-1]
    G = 0.5 * (G + G.mT)
    LB = jitter.cholesky(G + torch.eye(m, dtype=G.dtype, device=G.device))
    c = solve_lower(LB, u)
    w = _solve_lower_t(LB, c)
    beta = _solve_lower_t(Lm, w)
    return LB, w, beta


def titsias_assemble(logdet_d, LB, quad, trace_num, n_total):
    """Assemble the collapsed ELBO from its stable pieces."""
    logdet = logdet_d + 2.0 * torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)), dim=-1)
    lognorm = -0.5 * (n_total * LOG_2PI + logdet + quad)
    return lognorm - 0.5 * trace_num
