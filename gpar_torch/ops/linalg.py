"""Dense linear algebra for the GP core.

Port of ``gpar_tpu/ops/linalg.py``: jittered Cholesky factorisations with
an escalating retry ladder, sampling factors, triangular solves, MVN
log-densities and the collapsed Titsias (2009) ELBO with per-point noise
(reference call sites ``gpar/model.py:226,286-289``).

Factorisations are ``torch.linalg.cholesky_ex`` (cuSOLVER on the card).
The JAX package's blocked Cholesky is a TPU panel schedule, not a Pallas
kernel, and the JAX package itself leaves the factor to XLA off-TPU; it
has no counterpart here.

The retry ladder branches on ``cholesky_ex``'s ``info`` (a failed factor is
finite garbage, so ``isfinite`` cannot tell), which costs one host sync per
rung tried.  In eager PyTorch the rungs are real branches: a failed rung
never enters the autograd graph, so the JAX package's NaN-proof Cholesky
VJP (``_chol_grad_safe``) is not needed — the gradient is that of the rung
that succeeded.

A CUDA graph can hold no host read, so the graphed fit factors in one of
two ways, each with no read of its own:

- A caller that passes an ``escalations`` counter to
  :func:`titsias_factors` gets :func:`cholesky_ladder_on_device`: every
  rung is tried on the device without autograd, the first that holds is
  chosen by ``torch.where``, and the matrix is factored once more at that
  rung's jitter, with autograd.  Value and gradient are bit for bit those
  of the host-read ladder (the same factorisation of the same matrix; the
  unchosen rungs add exact zeros), at the price of the probes.  The JAX
  counterpart is the ladder through ``lax.cond``
  (``gpar_tpu/ops/linalg.py:337-380``).
- A caller whose every evaluation is followed by a host read anyway (the
  scan fit's L-BFGS bodies, which read their flags) passes
  ``escalations=FirstRung(failures)`` instead and gets
  :func:`cholesky_first_rung`: one factorisation, at the first rung, with
  autograd.  Where it holds it is the ladder's
  factor and gradient bit for bit; where it fails the factor is NaN and
  the counter says so, and the caller runs that work again on the ladder
  (``models.fused.run_scan_fit``).

The on-device ladder, the solves and the Titsias factors take a leading
batch axis (the JAX package vmaps its fits' objectives over restarts and
layers): every reduction runs over each element's own axes, and the ladder
picks its rung per element, as JAX's vmapped ``lax.cond`` does, so one
element's failing factorisation never changes another's jitter.  Unbatched
inputs take the same operations as before.
"""

from typing import NamedTuple

import torch

from ..config import config

__all__ = [
    "LOG_2PI",
    "resolve_epsilon",
    "floor_noise",
    "add_jitter",
    "safe_cholesky",
    "cholesky_ladder_on_device",
    "cholesky_first_rung",
    "FirstRung",
    "psd_sample_factor",
    "psd_sample_factor_batched",
    "sample_factor_first_rung",
    "counters",
    "reset_counters",
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
#: (the clamped eigendecomposition).  A CUDA graph's first rung
#: (:func:`sample_factor_first_rung`) counts in none of them.
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


def _attempt(K, e):
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(K + e * eye)
    return L, bool(info.item() == 0)


#: Order above which a batch of CUDA matrices is factored one matrix at a
#: time: cuSOLVER's batched ``potrf`` (which ``cholesky_ex`` takes for any
#: batch) is made for small matrices, and two dense restarts at 11 840 rows
#: took 4.4 times one restart's fit through it on an H100 (PERF.md §6,
#: PR 9).  Each element then gets the factor the unbatched route computes.
BATCHED_CHOLESKY_MAX_N = 512


def _cholesky_ex(A):
    """``torch.linalg.cholesky_ex`` of ``A``; a batch of large CUDA matrices
    one matrix at a time (:data:`BATCHED_CHOLESKY_MAX_N`)."""
    if A.ndim == 2 or not A.is_cuda or A.shape[-1] <= BATCHED_CHOLESKY_MAX_N:
        return torch.linalg.cholesky_ex(A)
    parts = [torch.linalg.cholesky_ex(a) for a in A.reshape(-1, *A.shape[-2:])]
    return (torch.stack([L for L, _ in parts]).reshape(A.shape),
            torch.stack([i for _, i in parts]).reshape(A.shape[:-2]))


def cholesky_ladder_on_device(K, escalations, epsilon=None):
    """:func:`safe_cholesky` with no host read.  Every rung's factorisation
    is tried without autograd, the jitter of the first that holds is
    selected on the device, and ``K`` plus that jitter is factored again
    with autograd; a NaN matrix if every rung fails.  A factorisation that
    needed more than the first rung adds one to the integer device tensor
    ``escalations``.  ``K`` (B, n, n) takes its rungs per element, and
    every element that escalates counts."""
    eps = resolve_epsilon(K.dtype, epsilon)
    if K.shape[-1] == 0:
        return torch.zeros_like(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    # The relative rung's jitter keeps its gradient, as in the eager ladder;
    # the where-chain passes it on only when that rung is chosen.
    rel = torch.clamp_min(1e-6 * torch.amax(torch.abs(torch.diagonal(K, dim1=-2, dim2=-1)), -1),
                          eps)
    rungs = [eps] + [eps * f for f in config.cholesky_retry_factors]

    def jit(e):
        return e[..., None, None] if isinstance(e, torch.Tensor) and e.ndim else e

    with torch.no_grad():
        ok = [_cholesky_ex(K + jit(e) * eye)[1] == 0 for e in rungs + [rel]]
        escalations.add_(torch.sum(~ok[0]).to(escalations.dtype))
    e = rel
    for r, held in zip(reversed(rungs), reversed(ok[:-1])):
        e = torch.where(held, r, e)
    L, _ = _cholesky_ex(K + jit(e) * eye)
    return torch.where(jit(torch.stack(ok).any(0)), L, float("nan"))


def cholesky_first_rung(K, failures, epsilon=None):
    """The first rung of :func:`cholesky_ladder_on_device` alone, with
    autograd and no host read: ``cholesky_ex(K + eps I)``, the very
    factorisation the ladder makes where its first rung holds, so there its
    value and gradient bit for bit.  Where it fails the factor is NaN (as
    the ladder's where every rung fails), and each failing element of a
    batch (B, n, n) adds one to the integer device tensor ``failures``.
    :func:`sample_factor_first_rung` is the same rung for the sampling
    factors; this one keeps :func:`_cholesky_ex`'s one-matrix-at-a-time
    route for a batch of large matrices, as the ladder does."""
    eps = resolve_epsilon(K.dtype, epsilon)
    if K.shape[-1] == 0:
        return torch.zeros_like(K)
    L, info = _cholesky_ex(K + eps * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device))
    bad = info != 0
    failures.add_(torch.sum(bad).to(failures.dtype))
    return torch.where(bad[..., None, None], float("nan"), L)


class FirstRung(NamedTuple):
    """An ``escalations`` argument (:func:`titsias_factors` and the callers
    that pass it on) that asks for :func:`cholesky_first_rung` in place of
    the ladder on the device, its failures counted into ``failures``."""

    failures: torch.Tensor


def safe_cholesky(K, epsilon=None):
    """Cholesky with escalating-jitter retries.

    Tries ``K + eps I``; on failure escalates the jitter by
    ``config.cholesky_retry_factors``; as a last resort uses a jitter
    relative to the matrix's own scale, ``max(1e-6 max|diag K|, eps)``.
    Returns a NaN matrix if every rung fails (the JAX package's NaN
    primal)."""
    eps = resolve_epsilon(K.dtype, epsilon)
    n = K.shape[-1]
    if n == 0:
        return torch.zeros_like(K)
    L, ok = _attempt(K, eps)
    for factor in config.cholesky_retry_factors:
        if ok:
            return L
        L, ok = _attempt(K, eps * factor)
    if ok:
        return L
    rel = torch.clamp_min(1e-6 * torch.max(torch.abs(torch.diagonal(K))), eps)
    L, ok = _attempt(K, rel)
    return L if ok else torch.full_like(K, float("nan"))


def psd_sample_factor(K, epsilon=None):
    """A finite factor ``F`` with ``F F^T ~= K`` for MVN sampling: the
    jittered Cholesky through :func:`safe_cholesky`'s rungs, or — when no
    rung repairs an indefinite matrix — an eigendecomposition with
    eigenvalues clamped at the jitter level."""
    return psd_sample_factor_batched(K[None], epsilon)[0]


def psd_sample_factor_batched(K, epsilon=None):
    """:func:`psd_sample_factor` over a leading batch axis, ``K`` (S, n, n)
    (``gpar_tpu/ops/linalg.py:409-467``): one batched Cholesky at the first
    rung; each further rung (the retry factors, then the relative jitter
    ``max(1e-6 max|diag K_s|, eps)`` of each element) runs only on the
    elements that are still failing, and the clamped eigendecomposition
    only on those that every rung failed.  Factors that hold are kept.  One
    host read of ``info`` per rung tried, counted (:func:`counters`)."""
    eps = resolve_epsilon(K.dtype, epsilon)
    if K.shape[-1] == 0:
        return torch.zeros_like(K)
    _COUNTS["sample_factor_batches"] += 1
    L, info = sample_factor_first_rung(K, eps)
    rel = torch.clamp_min(1e-6 * torch.amax(torch.abs(torch.diagonal(K, dim1=-2, dim2=-1)), -1), eps)
    rungs = [eps * f for f in config.cholesky_retry_factors] + [rel]
    bad = torch.nonzero(info).flatten()
    _COUNTS["sample_factor_rungs"] += 1
    if bad.numel() == 0:
        return L
    _COUNTS["sample_factor_escalations"] += bad.numel()
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    for e in rungs:
        e = e[bad, None, None] if isinstance(e, torch.Tensor) else e
        Lb, info_b = torch.linalg.cholesky_ex(K[bad] + e * eye)
        L[bad] = Lb
        bad = bad[info_b != 0]
        _COUNTS["sample_factor_rungs"] += 1
        if bad.numel() == 0:
            return L
    _COUNTS["sample_factor_eigh"] += bad.numel()
    w, V = torch.linalg.eigh(K[bad])
    L[bad] = V * torch.sqrt(torch.clamp_min(w, eps))[..., None, :]
    return L


def sample_factor_first_rung(K, epsilon=None):
    """The first rung of :func:`psd_sample_factor_batched`, ``(L, info)`` of
    ``cholesky_ex(K + eps I)`` for ``K`` (S, n, n), with no host read: the
    call that function makes first, so a factor that holds here is its
    factor.  The cached tail's CUDA graph takes it on the device."""
    eps = resolve_epsilon(K.dtype, epsilon)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.linalg.cholesky_ex(K + eps * eye)


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


def _mv(A, v):
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


def _cholesky(K, epsilon, escalations):
    """The host ladder without ``escalations``, the first rung alone with a
    :class:`FirstRung`, else the ladder on the device."""
    if escalations is None:
        return safe_cholesky(K, epsilon)
    if isinstance(escalations, FirstRung):
        return cholesky_first_rung(K, escalations.failures, epsilon)
    return cholesky_ladder_on_device(K, escalations, epsilon)


def titsias_factors(Kmm, Kmn, knn_diag, y, mean, noise_diag, epsilon=None, mask=None,
                    escalations=None):
    """Collapsed Titsias ELBO and the sparse-posterior factors from one
    factorisation pass: ``(elbo, Lm, LB, beta)`` with ``Lm = chol(Kmm)``,
    ``LB = chol(I + Lm^{-1} Kmn D^{-1} Knm Lm^{-T})`` and
    ``beta = (Kmm + Kmn D^{-1} Knm)^{-1} Kmn D^{-1} r``.

    ``mask`` (optional (n,) of 0/1) excludes rows exactly: a masked row's
    ``D^{-1}`` is zero and its logdet/count contributions vanish.

    ``escalations`` (optional integer device tensor): factor through
    :func:`cholesky_ladder_on_device`, which reads nothing back to the host
    and counts into it, instead of :func:`safe_cholesky`; a
    :class:`FirstRung`: through :func:`cholesky_first_rung`, counting its
    failures.

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

    Lm = _cholesky(Kmm, epsilon, escalations)
    A0 = solve_lower(Lm, Kmn)  # (m, n), O(1) entries
    qnn = torch.sum(A0 * A0, dim=-2)
    trace_num = torch.sum(torch.clamp_min(knn_diag - qnn, 0.0) * d_inv, dim=-1)
    G = (A0 * d_inv[..., None, :]) @ A0.mT
    u = _mv(A0, r * d_inv)
    LB, w, beta = titsias_solve(G, u, Lm, escalations)
    est = _mv(A0.mT, w)
    quad = torch.sum(r * (r - est) * d_inv, dim=-1)
    elbo = titsias_assemble(logdet_d, LB, quad, trace_num, n_eff)
    return elbo, Lm, LB, beta


def titsias_solve(G, u, Lm, escalations=None):
    """The O(m^3) core of the collapsed ELBO: ``LB = chol(I + G)`` (through
    the retry ladder — in float32 near the noise floor ``I + G`` can be
    numerically indefinite), ``w = LB^{-T} LB^{-1} u`` and
    ``beta = Lm^{-T} w``.  ``G`` is resymmetrised first; ``escalations``
    as in :func:`titsias_factors`."""
    m = G.shape[-1]
    G = 0.5 * (G + G.mT)
    LB = _cholesky(G + torch.eye(m, dtype=G.dtype, device=G.device), None, escalations)
    c = solve_lower(LB, u)
    w = _solve_lower_t(LB, c)
    beta = _solve_lower_t(Lm, w)
    return LB, w, beta


def titsias_assemble(logdet_d, LB, quad, trace_num, n_total):
    """Assemble the collapsed ELBO from its stable pieces."""
    logdet = logdet_d + 2.0 * torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)), dim=-1)
    lognorm = -0.5 * (n_total * LOG_2PI + logdet + quad)
    return lognorm - 0.5 * trace_num
