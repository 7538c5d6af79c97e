"""The work a request's mathematics needs, as functions of a configuration's
sizes, and the H100's published peaks.

``gram_bound_ms`` and ``gram_bwd_bound_ms`` are frozen copies of
``chip_smoke.py``'s, so that later changes to the program cannot
move the yardstick.  Everything is counted at the real rows and each
layer's own input width, never at a row bucket or the program's gated
width, and nothing the program chooses (padding, jitter-ladder probes,
kernels) is counted: the counts read the same work whatever implements it.

Conventions: a multiply and an add are two operations; a symmetric product
or Gram counts the half it needs; a triangular solve against ``k``
right-hand sides of order ``n`` needs ``n^2 k``, a Cholesky ``n^3 / 3``;
the backward of a dense linear-algebra step is counted at twice its
forward, the usual reverse-mode cost.
"""

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
H100_FP64_FLOPS = 34e12  # float64 outside the tensor cores
H100_FP64_TC_FLOPS = 67e12  # float64 on the tensor cores (cuBLAS's DGEMM)

#: Operations of the Gram backward per output element and feature of a term,
#: and per output element for the term's tail, by kind (chip_smoke.py).
BWD_OPS = {"rbf": (6, 4), "rq": (6, 10), "lin": (4, 1)}


def gram_bound_ms(kinds, dims, n, m, itemsize, batch=1, shared=""):
    """Least time of one Gram on an H100: the larger of the bytes it must
    move (features read once, Gram written once) over the memory rate and
    its operations over the non-tensor-core rate of the dtype, and which
    of the two binds."""
    D = sum(dims)
    rows = (n if shared == "left" else batch * n) + (m if shared == "right" else batch * m)
    bytes_ = itemsize * (batch * n * m + rows * D + 2 * len(kinds) + 1)
    per_elem = 2 * D + 4 * len(kinds) + 1
    flops = batch * n * m * per_elem
    peak = H100_FP32_FLOPS if itemsize == 4 else H100_FP64_FLOPS
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gram_bwd_bound_ms(kinds, dims, n, m, itemsize):
    """Least time of one Gram backward on an H100, the same way."""
    D = sum(dims)
    bytes_ = itemsize * (n * m + 2 * (n + m) * D + 2 * (2 * len(kinds) + 1))
    per_elem = 1 + sum(BWD_OPS[k][0] * d + BWD_OPS[k][1] for k, d in zip(kinds, dims))
    flops = n * m * per_elem + sum(2 * n * d for k, d in zip(kinds, dims) if k == "lin")
    peak = H100_FP32_FLOPS if itemsize == 4 else H100_FP64_FLOPS
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def layer_terms(i, m):
    """Layer ``i``'s kernel terms and their input widths: EQ on the ``m``
    inputs, and for ``i > 0`` a linear and an EQ term on the ``i`` previous
    outputs."""
    if i == 0:
        return ["rbf"], [m]
    return ["rbf", "lin", "rbf"], [m, i, i]


def gram_ops(kinds, dims, n, m, symmetric=False):
    per_elem = 2 * sum(dims) + 4 * len(kinds) + 1
    elems = n * (n + 1) / 2 if symmetric else n * m
    return elems * per_elem


def gram_bwd_ops(kinds, dims, n, m):
    per_elem = 1 + sum(BWD_OPS[k][0] * d + BWD_OPS[k][1] for k, d in zip(kinds, dims))
    return n * m * per_elem + sum(2 * n * d for k, d in zip(kinds, dims) if k == "lin")


def _layer_eval(i, sz, grad):
    """Operations and Gram bounds (ms) of one evaluation of layer ``i``'s
    objective at ``sz`` (``n`` rows, ``m`` inputs, ``M`` inducing points,
    0 for the exact model), with its gradient when ``grad``."""
    n, m, M, it = sz["n"], sz["m"], sz["M"], sz["itemsize"]
    kinds, dims = layer_terms(i, m)
    if M:
        grams = [(M, M), (M, n)]
        panel = 2 * M**3 / 3 + 2 * M**2 * n + 6 * M * n + 3 * M**2 + 6 * n
        fwd_gram = gram_ops(kinds, dims, M, M, True) + gram_ops(kinds, dims, M, n)
    else:
        grams = [(n, n)]
        panel = n**3 / 3 + 2 * n**2 + 3 * n
        fwd_gram = gram_ops(kinds, dims, n, n, True)
    ops = panel + fwd_gram
    bound = sum(gram_bound_ms(kinds, dims, a, b, it)[0] for a, b in grams)
    if grad:
        # Dense: the gradient through K^-1, formed from the factor (2 n^3 / 3)
        # and the outer product of alpha; sparse: twice the panel.
        ops += (2 * n**3 / 3 + n**2) if not M else 2 * panel
        ops += sum(gram_bwd_ops(kinds, dims, a, b) for a, b in grams)
        bound += sum(gram_bwd_bound_ms(kinds, dims, a, b, it)[0] for a, b in grams)
    return ops, bound


def _predict_layer(i, sz, t, S):
    """Operations and Gram bounds of layer ``i`` of the predictive at ``t``
    test inputs with ``S`` draws, from the conditioned factors."""
    n, m, M, it = sz["n"], sz["m"], sz["M"], sz["itemsize"]
    kinds, dims = layer_terms(i, m)
    r = M if M else n  # rows of the cross-covariance
    ops = gram_ops(kinds, dims, r, t) + gram_ops(kinds, dims, t, t, True)
    ops += 2 * r * t + (2 if M else 1) * r**2 * t + (2 if M else 1) * t**2 * r
    ops += t**3 / 3 + S * t**2 + 3 * S * t
    bound = gram_bound_ms(kinds, dims, r, t, it)[0] + gram_bound_ms(kinds, dims, t, t, it)[0]
    return ops, bound


def fit_work(sz, report):
    """``(operations, Gram bound ms)`` of one fit from its report: per layer
    its start and each iteration (value and gradient), each backtracking
    episode's re-evaluation (value and gradient), each backtracking trial
    (value) and the final evaluation that conditions the layer (value);
    the episodes and trials, reported in total, are spread over the layers
    at the layers' mean cost."""
    p = sz["p"]
    iters = np.asarray(report["layer_iters"], dtype=float)
    g = [_layer_eval(i, sz, True) for i in range(p)]
    v = [_layer_eval(i, sz, False) for i in range(p)]
    ops = sum((1 + iters[i]) * g[i][0] + v[i][0] for i in range(p))
    bound = sum((1 + iters[i]) * g[i][1] + v[i][1] for i in range(p))
    ops += report["linesearch_episodes"] * np.mean([a for a, _ in g])
    bound += report["linesearch_episodes"] * np.mean([b for _, b in g])
    ops += report["linesearch_trials"] * np.mean([a for a, _ in v])
    bound += report["linesearch_trials"] * np.mean([b for _, b in v])
    return float(ops), float(bound)


def predict_work(sz, t, S):
    """``(operations, Gram bound ms)`` of one ``replace=True`` predictive of
    ``S`` draws at ``t`` test inputs from conditioned factors."""
    parts = [_predict_layer(i, sz, t, S) for i in range(sz["p"])]
    return float(sum(a for a, _ in parts)), float(sum(b for _, b in parts))


def evaluations(report):
    """Layer evaluations of a fit as its report gives them: the layer starts,
    the iterations and the backtracking trials."""
    return len(report["layer_iters"]) + int(np.sum(report["layer_iters"])) + int(
        report["linesearch_trials"])
