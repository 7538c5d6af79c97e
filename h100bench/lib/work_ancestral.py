"""The work of one ``replace=False`` predict of the exact model with
rational-quadratic kernels, from the conditioned data: per layer its
training factors computed anew with the imputation of its gaps, then per
sample the posterior at the sample's own test inputs, its sampling factor
and its draw.

Counted as ``work.py`` counts (its conventions and its Gram functions): at
the real rows and each layer's own input width (1 + i), at the request's
real test inputs, never at a bucket, the gated width, the ladder's probes
or the kernels chosen.  A layer's training factors are of its observed
rows alone; the rows of its gaps need the cross-covariance to them and the
posterior mean there (the imputation).  The posterior of every sample
solves against the layer's one factor (``n^2 t`` a sample) and takes half
of ``V^T V`` (``t^2 n``); its sampling factor is one Cholesky of order
``t`` (``t^3 / 3``).
"""

from .work import gram_bound_ms, gram_ops


def layer_terms(i, m):
    """Layer ``i``'s kernel terms and their input widths: RQ on the ``m``
    inputs, and for ``i > 0`` a linear and an RQ term on the ``i`` previous
    outputs."""
    if i == 0:
        return ["rq"], [m]
    return ["rq", "lin", "rq"], [m, i, i]


def layer_factors(i, sz):
    """Operations and Gram bound (ms) of layer ``i``'s training factors on
    its ``sz["observed"][i]`` observed rows of ``sz["n"]``: the Gram of the
    observed rows and its cross-covariance to the gap rows, the Cholesky,
    the two solves of the weights, the NLL's terms and the posterior mean
    at the gap rows."""
    n, m, it = sz["observed"][i], sz["m"], sz["itemsize"]
    gap = sz["n"] - n
    kinds, dims = layer_terms(i, m)
    ops = gram_ops(kinds, dims, n, n, True) + gram_ops(kinds, dims, gap, n)
    ops += n**3 / 3 + 2 * n**2 + 3 * n + 2 * gap * n
    bound = gram_bound_ms(kinds, dims, n, n, it)[0]
    if gap:
        bound += gram_bound_ms(kinds, dims, gap, n, it)[0]
    return ops, bound


def layer_samples(i, sz, t, S):
    """Operations and Gram bound (ms) of layer ``i``'s ``S`` per-sample
    posteriors, sampling factors and draws at ``t`` test inputs: per sample
    the cross-covariance (``n`` x ``t``) and the test Gram (symmetric), the
    mean, the solve against the layer's factor, half of ``V^T V``, the
    Cholesky of order ``t``, the draw and the noise.  The Grams are two
    launches with a sample axis, the training rows shared."""
    n, m, it = sz["observed"][i], sz["m"], sz["itemsize"]
    kinds, dims = layer_terms(i, m)
    per = gram_ops(kinds, dims, n, t) + gram_ops(kinds, dims, t, t, True)
    per += 2 * n * t + n**2 * t + t**2 * n + t**3 / 3 + t**2 + 3 * t
    bound = (gram_bound_ms(kinds, dims, n, t, it, batch=S, shared="left")[0]
             + gram_bound_ms(kinds, dims, t, t, it, batch=S)[0])
    return S * per, bound


def predict_work(sz, t, S):
    """``(operations, Gram bound ms)`` of one ``replace=False`` predict of
    ``S`` draws at ``t`` test inputs, the training factors computed anew."""
    parts = [layer_factors(i, sz) for i in range(sz["p"])]
    parts += [layer_samples(i, sz, t, S) for i in range(sz["p"])]
    return float(sum(a for a, _ in parts)), float(sum(b for _, b in parts))
