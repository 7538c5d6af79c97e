"""Scan-fused fit and predict tail: every layer through one step at uniform
shapes.

Port of the single-device parts of ``gpar_tpu/models/fused.py``.  The JAX
package makes every layer's body shape-uniform so that one ``lax.scan``
body serves all p layers; here the same uniformity lets one set of CUDA
graphs, captured once, serve every layer and every L-BFGS iteration
(``models/graphs.py``):

- **Uniform widths.** The augmented inputs are allocated at their final
  width ``W = m + p`` (the last column is gated scratch); layer pi's active
  columns are selected by 0/1 gates (``ops.kernels.Gate``) instead of
  ``select``.
- **Uniform rows.** The ``per_output`` filtering and ``_obs``'s NaN drop
  become 0/1 row masks over all rows: a masked row has ``D^{-1} = 0`` in
  the Titsias ELBO (``ops.linalg.titsias_factors(mask=...)``), so the
  layer NLL equals the filtered one to rounding.  Rows are padded to a
  shape bucket (``config.bucket_rows``): ``y`` pads with NaN and ``w``
  with 1, so padded rows drop out of every mask.
- **Uniform parameters.** Each layer's hyperparameters are gathered from
  the flat latent vector through per-layer index maps padded with a dummy
  slot (latent 0, always gated out), and constrained with the store's own
  transforms.

The plan (:func:`build_scan_data_plan`) is NumPy, built on the host with
the JAX package's names and dtypes; its row arrays are derived on the
device from the bucket-padded data (:func:`device_bucket_inputs`).

The fit (:func:`make_scan_fit_body`) is a Python loop over layers running
one step at the uniform shapes, :class:`ScanStep`: L-BFGS on the layer's
objective (``params.lbfgs.DeviceLBFGS``), then one augmentation step that
writes the layer's output column into the augmented inputs in place.  The
step's bodies are plain functions of fixed-shape buffers; on a CUDA tensor
they are captured once as CUDA graphs and replayed, on a CPU tensor (or
when asked) they run eagerly.  A sparse plan (inducing points) takes the
masked Titsias ELBO; a dense one (``x_ind=None``) the exact marginal
likelihood of the (rows, rows) covariance with masked rows made identity
rows (:func:`_masked_dense_factors`), and no inducing inputs.

The serving tails run eagerly, under ``no_grad``, from caller-supplied
standard normals:

- :func:`make_scan_predict_tail` (``replace=True``): per layer the
  Titsias or exact factors, the posterior at the bucketed and masked test
  rows, one sampling factor and all Monte-Carlo draws as one matmul;
- :func:`make_scan_ancestral_tail` (``replace=False``, posterior
  ``sample``) and :func:`make_scan_prior_tail` (prior ``sample``):
  per-sample chains, each sample with its own augmented test inputs, so a
  layer takes a Gram with a sample axis (one launch of the Gram kernel),
  a batched posterior covariance and a batched sampling factor
  (``ops.linalg.psd_sample_factor_batched``), in chunks of samples
  (:func:`resolve_sample_chunk`).  The tail computes each layer's
  posterior factors inside its loop (:func:`posterior_factor_layers`);
  :func:`make_scan_posterior_factors` stacks them, for the factor cache
  that is not ported yet.

The whole chain's log-density is written once, :func:`_chain_nll`: per
layer the masked layer NLL, then one augmentation step out of place
(:func:`_augmented`), so that autograd can differentiate through the
columns that earlier layers write.  :func:`make_scan_logpdf_body` (the
prior score) evaluates it under ``no_grad``; :func:`make_scan_free_fit_body`
(``fit(fix=False)``) minimises it at each position over the latents of
layers ``0..pi``, eagerly.  :func:`make_scan_posterior_logpdf_tail` scores
new data under the posterior, each layer's training factors taken from
:func:`posterior_factor_layers`.

Multi-start fits (``restarts > 1``) and ``fused="batched"`` evaluate the
layer objective over a batch of latent vectors: ``z_full`` (B, n_z + 1)
gives a kernel tree whose leaves carry the batch axis
(:func:`_layer_kernel`), the Grams and their gradients are one batched
launch of each kernel, and the factorisations, the jitter ladder and the
NLL are per element, (B,).  One batched L-BFGS
(``params.lbfgs.BatchedDeviceLBFGS``) runs every element's trajectory:
:class:`ScanStep` with ``restarts = R`` holds the R starts of the current
layer and keeps the best at ``layer_finish``; the joint fit restarts over
each position's prefix span; :func:`make_batched_fit_body` fits all p
layers times R starts as one batch.  Unbatched latents take the same
operations as before.

Not ported: the posterior-factor cache (``make_scan_cached_tail``),
``fused="unroll"``, and the mesh.
"""

import contextlib
import functools
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import gram_kernel as GK
from ..ops.kernels import EQ, RQ, Const, Linear, gram, kdiag
from ..ops.linalg import (
    LOG_2PI,
    _cholesky,
    _mv,
    floor_noise,
    psd_sample_factor,
    psd_sample_factor_batched,
    resolve_epsilon,
    solve_chol,
    solve_lower,
    titsias_factors,
)
from ..params.lbfgs import (
    MAX_LINESEARCH, BatchedDeviceLBFGS, DeviceLBFGS, best_of, iterate, new_stats,
)
from ..params.store import _Bounded, _Identity, _LowerBounded

__all__ = [
    "ScanFitPlan",
    "ScanStep",
    "Eager",
    "build_scan_data_plan",
    "build_scan_fit_plan",
    "device_bucket_inputs",
    "pad_plan_rows",
    "plan_static_fingerprint",
    "plan_tensors",
    "make_scan_fit_body",
    "make_scan_free_fit_body",
    "make_batched_fit_body",
    "make_scan_logpdf_body",
    "make_scan_posterior_logpdf_tail",
    "make_scan_predict_tail",
    "make_scan_posterior_factors",
    "posterior_factor_layers",
    "make_scan_ancestral_tail",
    "build_scan_prior_plan",
    "make_scan_prior_tail",
    "resolve_sample_chunk",
    "run_scan_fit",
]

# Constrained transforms per field, the store's own rules.
_POS = _LowerBounded(0.0)
_NOISE = _LowerBounded(1e-8)
_ALPHA = _Bounded(1e-3, 1e3)
_ID = _Identity()

#: Plan entries carrying one value per data row (everything else in the
#: plan is model structure: index maps, gates, column ids).
_ROW_KEYS = ("route_mask", "obs_mask", "avail", "y_col", "w_col")


def pad_plan_rows(plan, n_rows):
    """Host-side padded copies of the plan's per-layer row arrays: data and
    masks pad with 0, weights with 1 (they divide the noise).  Returns a
    dict of (p, n_rows) NumPy arrays."""
    pad = n_rows - plan.n
    out = {}
    for k in _ROW_KEYS:
        v = np.asarray(plan.xs[k])
        if pad:
            v = np.pad(v, ((0, 0), (0, pad)), constant_values=1.0 if k == "w_col" else 0.0)
        out[k] = v
    return out


def device_bucket_inputs(x, y, w, *, n_b, impute, device):
    """Bucketed fit inputs: the data padded to ``n_b`` rows on the host (y
    with NaN, w with 1, so padded rows drop out of every mask), uploaded
    once, and the per-layer row arrays (:data:`_ROW_KEYS`) derived on the
    device — the closed-downwards ``per_output`` routing of
    ``gpar/model.py:325-368`` as cumulative mask algebra.  Values equal
    ``pad_plan_rows(build_scan_data_plan(...), n_b)`` exactly.  Returns
    ``(x_pad, rows)``."""
    x, y, w = np.asarray(x), np.asarray(y), np.asarray(w)
    pad = n_b - y.shape[0]
    x_pad = np.pad(x, ((0, pad), (0, 0)))
    y_pad = np.pad(y, ((0, pad), (0, 0)), constant_values=np.nan)
    w_pad = np.pad(w.astype(x.dtype), ((0, pad), (0, 0)), constant_values=1.0)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return _device_plan_rows(up(x_pad), up(y_pad), up(w_pad), impute=impute)


def _device_plan_rows(x_pad, y_pad, w_pad, *, impute):
    """The device half of :func:`device_bucket_inputs`."""
    dtype = x_pad.dtype
    yT = y_pad.T
    avail_b = ~torch.isnan(yT)  # (p, n_b)
    avail = avail_b.to(dtype)
    if impute:
        # keep[pi] = avail[pi] | any(avail[pi+1:]) for pi < p-1; the last
        # layer keeps its own availability (per_output keep=True).
        suffix = torch.flip(torch.cummax(torch.flip(avail_b, [0]).to(torch.int64), dim=0).values, [0])
        keep = torch.cat([avail_b[:-1] | (suffix[1:] > 0), avail_b[-1:]], dim=0)
    else:
        keep = avail_b
    route = torch.cumprod(keep.to(dtype), dim=0)  # cumulative AND
    rows = {
        "route_mask": route,
        "obs_mask": route * avail,
        "avail": avail,
        "y_col": torch.nan_to_num(yT, nan=0.0).to(dtype),
        "w_col": w_pad.to(dtype).T,
    }
    return x_pad, {k: v.contiguous() for k, v in rows.items()}


def _mask_test_cov(cov_t, mt):
    """Neutralise padded test rows in a predictive covariance: masked rows
    and columns zero, identity on the padded diagonal, so the real block's
    factor, and its draws, are those of the unpadded matrix."""
    if mt is None:
        return cov_t
    return cov_t * (mt[:, None] * mt[None, :]) + torch.diag(1.0 - mt)


@dataclass
class ScanFitPlan:
    """Host-side plan of the scan-fused fit (static per dataset and model
    configuration)."""

    m: int
    p: int
    W: int  # augmented width m + p; the last column is gated scratch
    n: int
    s_max: int  # padded per-layer latent span
    n_z: int  # total latents (the dummy slot's index)
    xs: dict  # stacked per-layer arrays (NumPy)
    config: dict  # model_config
    sparse: bool
    impute: bool
    replace: bool


def plan_static_fingerprint(plan):
    """Fingerprint of everything the layer step bakes in: the plan
    scalars, the model-config switches and the data-independent per-layer
    arrays (index maps, gates) — not the row count or the row arrays, which
    are loaded into the step's buffers for every fit."""

    def _scalar(v):
        if isinstance(v, (np.ndarray, list, tuple)):
            a = np.asarray(v)
            return (str(a.dtype), a.shape, a.tobytes())
        return repr(v)

    h = hashlib.sha256()
    cfg = tuple(sorted((k, _scalar(v)) for k, v in plan.config.items()))
    h.update(repr((plan.m, plan.p, plan.W, plan.s_max, plan.n_z, plan.sparse, plan.impute,
                   plan.replace, cfg)).encode())
    for k in sorted(plan.xs):
        if k in _ROW_KEYS:
            continue
        v = np.ascontiguousarray(np.asarray(plan.xs[k]))
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(repr(v.shape).encode())
        h.update(v.tobytes())
    return h.hexdigest()


def _name_offsets(vs, all_names):
    offsets = {}
    off = 0
    for name in all_names:
        size = int(np.prod(tuple(vs._latents[name].shape)))
        offsets[name] = (off, size)
        off += size
    return offsets, off


def _field_idx(offsets, name, actual, padded, dummy, shift=0):
    """Index map of a (possibly absent or short) variable into the flat
    latent vector, padded with the dummy slot."""
    idx = np.full(padded, dummy, dtype=np.int32)
    if name in offsets and actual > 0:
        off, size = offsets[name]
        assert size == actual, (name, size, actual)
        idx[shift : shift + actual] = np.arange(off, off + actual, dtype=np.int32)
    return idx


def _kernel_field_xs(vs, all_names, m, p, W, cfg, dtype):
    """Data-independent per-layer arrays: the latent-span gather map and the
    kernel-field index maps and gates :func:`_layer_kernel` consumes."""
    offsets, n_z = _name_offsets(vs, all_names)
    dummy = n_z

    # Per-layer latent spans (the names=[f"{pi}/*"] filter,
    # ``gpar/regression.py:452-456``) padded to a uniform length.
    spans = []
    for pi in range(p):
        idx = np.concatenate(
            [np.arange(offsets[nm][0], offsets[nm][0] + offsets[nm][1]) for nm in vs.select([f"{pi}/*"])]
        ).astype(np.int32)
        spans.append(idx)
    s_max = max(len(s) for s in spans)
    layer_gather = np.full((p, s_max), dummy, dtype=np.int32)
    for pi, s in enumerate(spans):
        layer_gather[pi, : len(s)] = s

    from .regressor import _determine_indices

    P1 = W - m  # padded output-column count (incl. the scratch column)
    xs = {
        "layer_gather": layer_gather,
        "in_var": np.zeros((p,), np.int32),
        "in_scales": np.zeros((p, m), np.int32),
        "noise": np.zeros((p,), np.int32),
        "out_gate": np.zeros((p, P1), dtype),
        "nl_gate": np.zeros((p,), dtype),
        "outlin_scales": np.zeros((p, P1), np.int32),
        "outnl_var": np.zeros((p,), np.int32),
        "outnl_scales": np.zeros((p, P1), np.int32),
    }
    if cfg["rq"]:
        xs["in_alpha"] = np.zeros((p,), np.int32)
        xs["outnl_alpha"] = np.zeros((p,), np.int32)
    if cfg["per"]:
        xs["per_var"] = np.zeros((p,), np.int32)
        xs["per_scales"] = np.zeros((p, 2 * m), np.int32)
        xs["per_pers"] = np.zeros((p, m), np.int32)
        xs["per_decay"] = np.zeros((p, m), np.int32)
    if cfg["input_linear"]:
        xs["inlin_scales"] = np.zeros((p, m), np.int32)
        xs["inlin_const"] = np.zeros((p,), np.int32)

    for pi in range(p):
        _, p_inds, p_num = _determine_indices(m, pi, cfg["markov"])
        p_start = (p_inds[0] - m) if p_num > 0 else 0

        xs["in_var"][pi] = _field_idx(offsets, f"{pi}/input/var", 1, 1, dummy)[0]
        scales_name = f"{0 if cfg['scale_tie'] else pi}/input/scales"
        xs["in_scales"][pi] = _field_idx(offsets, scales_name, m, m, dummy)
        xs["noise"][pi] = _field_idx(offsets, f"{pi}/noise", 1, 1, dummy)[0]
        if cfg["rq"]:
            xs["in_alpha"][pi] = _field_idx(offsets, f"{pi}/input/alpha", 1, 1, dummy)[0]
            xs["outnl_alpha"][pi] = _field_idx(offsets, f"{pi}/output/nonlin/alpha", 1, 1, dummy)[0]
        if cfg["per"]:
            xs["per_var"][pi] = _field_idx(offsets, f"{pi}/input/per/var", 1, 1, dummy)[0]
            xs["per_scales"][pi] = _field_idx(offsets, f"{pi}/input/per/scales", 2 * m, 2 * m, dummy)
            xs["per_pers"][pi] = _field_idx(offsets, f"{pi}/input/per/pers", m, m, dummy)
            xs["per_decay"][pi] = _field_idx(offsets, f"{pi}/input/per/decay", m, m, dummy)
        if cfg["input_linear"]:
            xs["inlin_scales"][pi] = _field_idx(offsets, f"{pi}/input/lin/scales", m, m, dummy)
            xs["inlin_const"][pi] = _field_idx(offsets, f"{pi}/input/lin/const", 1, 1, dummy)[0]

        if p_num > 0:
            xs["out_gate"][pi, p_start : p_start + p_num] = 1.0
            if cfg["linear"]:
                xs["outlin_scales"][pi] = _field_idx(
                    offsets, f"{pi}/output/lin/scales", p_num, P1, dummy, shift=p_start
                )
        # The output terms exist whenever pi > 0 (``gpar/regression.py:
        # 141,149`` condition on the layer index, not the selection width):
        # at markov=0 the nonlinear term degenerates to a constant variance,
        # so nl_gate keys on pi > 0 while out_gate stays zero.
        if cfg["nonlinear"] and pi > 0:
            xs["nl_gate"][pi] = 1.0
            xs["outnl_var"][pi] = _field_idx(offsets, f"{pi}/output/nonlin/var", 1, 1, dummy)[0]
            if p_num > 0:
                xs["outnl_scales"][pi] = _field_idx(
                    offsets, f"{pi}/output/nonlin/scales", p_num, P1, dummy, shift=p_start
                )

    xs["col"] = np.arange(p, dtype=np.int32)  # output column index per layer
    return xs, s_max, n_z


def build_scan_fit_plan(reg, all_names):
    """The plan of the regressor's conditioned data (its host copies)."""
    return build_scan_data_plan(reg, reg._x_np, reg._y_np, reg._w_np, all_names)


def build_scan_data_plan(reg, x_np, y_np, w_np, all_names):
    """The scan plan of explicit host data: the row arrays carry this
    data's values and NaN routing; the model-structure arrays depend only
    on the variable store and the configuration."""
    cfg = reg.model_config
    m, p, n = x_np.shape[1], y_np.shape[1], x_np.shape[0]
    W = m + p  # p - 1 real output columns + one gated scratch column
    dtype = np.dtype(x_np.dtype)

    avail = ~np.isnan(y_np)

    # Absolute row masks: the cumulative per_output routing
    # (``gpar/model.py:325-368``) composed onto the original n rows.
    keep = bool(reg.impute)
    route = np.ones(n, dtype=bool)
    route_mask = np.zeros((p, n), dtype=bool)
    for pi in range(p):
        if keep and pi < p - 1:
            layer_keep = avail[:, pi] | avail[:, pi + 1 :].any(axis=1)
        else:
            layer_keep = avail[:, pi]
        route = route & layer_keep
        route_mask[pi] = route
    obs_mask = route_mask & avail.T  # (p, n)

    xs, s_max, n_z = _kernel_field_xs(reg.vs, all_names, m, p, W, cfg, dtype)
    xs["route_mask"] = route_mask.astype(dtype)
    xs["obs_mask"] = obs_mask.astype(dtype)
    xs["avail"] = avail.T.astype(dtype)
    xs["y_col"] = np.nan_to_num(y_np, nan=0.0).T.astype(dtype)
    xs["w_col"] = w_np.T.astype(dtype)

    return ScanFitPlan(
        m=m, p=p, W=W, n=n, s_max=s_max, n_z=n_z, xs=xs, config=dict(cfg),
        sparse=reg.sparse, impute=bool(reg.impute), replace=bool(reg.replace),
    )


def plan_tensors(plan, dtype, device, rows=None):
    """The plan's stacked arrays on ``device``: index maps as int64, the
    rest in ``dtype``; ``rows`` (bucket-padded row arrays) replaces the
    plan's own exact-shape ones."""
    out = {}
    for k, v in plan.xs.items():
        if rows is not None and k in _ROW_KEYS:
            out[k] = rows[k].to(dtype=dtype, device=device)
        elif np.issubdtype(np.asarray(v).dtype, np.integer):
            out[k] = torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)
        else:
            out[k] = torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    return out


def _cat(*parts):
    """Concatenate along the last axis, broadcasting the leading ones (a
    batched field beside unbatched ones)."""
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in parts))
    return torch.cat([a.expand(*lead, a.shape[-1]) for a in parts], dim=-1)


def _layer_kernel(plan, lin, z_full):
    """Layer ``pi``'s prior kernel from gathered parameters: the uniform
    counterpart of ``_model_generator``'s composition
    (``gpar/regression.py:92-180``), gates in place of ``select``.

    ``z_full`` (B, n_z + 1) gives a tree whose leaves carry the batch axis;
    ``lin`` may carry it too (one layer's plan slice per element, as
    :func:`make_batched_fit_body` stacks them)."""
    cfg = plan.config
    m, P1 = plan.m, plan.W - plan.m
    dt, dev = z_full.dtype, z_full.device
    lead = z_full.shape[:-1]
    per_element = lin["in_var"].ndim > 0

    def nat(tr, idx):
        # A gather, not ``z_full[idx]``: indexing by a 0-d tensor reads the
        # index back to the host, which a CUDA graph capture refuses.
        if per_element:
            return tr.constrain(torch.gather(z_full, -1, idx.reshape(idx.shape[0], -1))
                                .reshape(idx.shape))
        return tr.constrain(z_full.index_select(-1, idx.reshape(-1)).reshape((*lead, *idx.shape)))

    def ones(k):
        return torch.ones((k,), dtype=dt, device=dev)

    def zeros(k):
        return torch.zeros((k,), dtype=dt, device=dev)

    gate_in = torch.cat([ones(m), zeros(P1)])
    gate_out = _cat(zeros(m), lin["out_gate"])

    # Input terms (first m dims; padded dims gated to zero).
    in_scales = _cat(nat(_POS, lin["in_scales"]), ones(P1))
    base_in = RQ(nat(_ALPHA, lin["in_alpha"])) if cfg["rq"] else EQ()
    kin = nat(_POS, lin["in_var"]) * base_in.stretch(in_scales)
    if cfg["per"]:
        per_scales = _cat(nat(_POS, lin["per_scales"]), ones(2 * P1))
        per_pers = _cat(nat(_POS, lin["per_pers"]), ones(P1))
        per_decay = _cat(nat(_POS, lin["per_decay"]), ones(P1))
        kin = kin + nat(_POS, lin["per_var"]) * EQ().stretch(per_scales).periodic(
            per_pers
        ) * EQ().stretch(per_decay)
    if cfg["input_linear"]:
        inlin_scales = _cat(nat(_POS, lin["inlin_scales"]), ones(P1))
        kin = kin + Linear().stretch(inlin_scales) + Const(nat(_ID, lin["inlin_const"]))
    kernel = kin.gate(gate_in)

    # Output terms (appended columns, gated by the Markov order; the
    # nonlinear variance is gated too, because EQ/RQ of all-zero inputs is
    # 1, not 0).
    if cfg["linear"]:
        outlin_scales = _cat(ones(m), nat(_POS, lin["outlin_scales"]))
        kernel = kernel + Linear().stretch(outlin_scales).gate(gate_out)
    if cfg["nonlinear"]:
        outnl_scales = _cat(ones(m), nat(_POS, lin["outnl_scales"]))
        base_out = RQ(nat(_ALPHA, lin["outnl_alpha"])) if cfg["rq"] else EQ()
        kernel = kernel + (lin["nl_gate"] * nat(_POS, lin["outnl_var"])) * (
            base_out.stretch(outnl_scales).gate(gate_out)
        )

    return kernel, nat(_NOISE, lin["noise"])


def _masked_dense_factors(K, r, mask, noise_w, eps, escalations=None):
    """Exact masked marginal likelihood and posterior-mean weights:
    ``(logpdf, alpha, L)``.  Masked rows become identity rows, so they add
    exactly nothing to the logdet, the quadratic form or ``alpha``; the
    factorisation adds ``eps`` to the whole diagonal, so a masked diagonal
    is set to ``1 - eps`` to land at 1.  With ``escalations`` the Cholesky
    takes the jitter ladder on the device
    (``ops.linalg.cholesky_ladder_on_device``), else the host ladder.

    ``K`` is (rows, rows): the masking multiplies by the two mask vectors
    (no (rows, rows) mask is formed or kept for the backward) and the
    diagonal is added in place.  A batch: ``K`` (B, rows, rows),
    ``noise_w`` (B, rows), ``r`` and ``mask`` (rows,) or (B, rows)."""
    A = K * mask[..., :, None] * mask[..., None, :]
    torch.diagonal(A, dim1=-2, dim2=-1).add_(mask * noise_w + (1.0 - mask) * (1.0 - eps))
    L = _cholesky(A, None, escalations)
    rm = r * mask
    if rm.ndim < L.ndim - 1:
        rm = rm.expand(L.shape[:-1])
    v = solve_lower(L, rm)
    logpdf = (-0.5 * torch.sum(mask, dim=-1) * LOG_2PI
              - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)) * mask, dim=-1)
              - 0.5 * torch.sum(v * v, dim=-1))
    return logpdf, solve_chol(L, rm), L


def _layer_nll_factors(plan, lin, z_full, x_aug, zi_aug, escalations=None):
    """Layer NLL and posterior-mean factors at uniform shapes: the masked
    Titsias ELBO (sparse) or exact marginal likelihood (dense) of layer
    ``lin`` at parameters ``z_full``, and the factors of
    :func:`_est_from_factors`, ``(Kmm, Kmn, beta)`` or ``(K, alpha)``.
    With ``escalations`` the factorisations take the jitter ladder on the
    device (``ops.linalg.cholesky_ladder_on_device``).  A batch of latents
    ``z_full`` (B, n_z + 1) gives (B,) NLLs and batched factors."""
    kernel, noise = _layer_kernel(plan, lin, z_full)
    noise_w = floor_noise((noise if noise.ndim == 0 else noise[..., None]) / lin["w_col"])
    r = lin["y_col"]  # zero-filled; masked rows neutralised
    if not plan.sparse:
        K = gram(kernel, x_aug, x_aug)
        logpdf, alpha, _ = _masked_dense_factors(K, r, lin["obs_mask"], noise_w,
                                                 resolve_epsilon(K.dtype), escalations)
        return -logpdf, (K, alpha)
    Kmm = gram(kernel, zi_aug, zi_aug)
    Kmn = gram(kernel, zi_aug, x_aug)
    knn = kdiag(kernel, x_aug)
    elbo, _, _, beta = titsias_factors(Kmm, Kmn, knn, r, torch.zeros_like(r), noise_w,
                                       mask=lin["obs_mask"], escalations=escalations)
    return -elbo, (Kmm, Kmn, beta)


def _est_from_factors(plan, factors):
    """Posterior-mean estimates at the data rows and, sparse, at the
    inducing inputs (``gpar/model.py:291-322``)."""
    if not plan.sparse:
        K, alpha = factors
        return _mv(K, alpha), None
    Kmm, Kmn, beta = factors
    return _mv(Kmn.mT, beta), _mv(Kmm, beta)


def _next_column(plan, lin, est_rows):
    """The output column fed forward, per the impute/replace rules."""
    avail, y_col = lin["avail"], lin["y_col"]
    if plan.impute and plan.replace:
        return est_rows
    if plan.impute:
        return torch.where(avail > 0, y_col, est_rows)
    if plan.replace:
        return torch.where(avail > 0, est_rows, y_col)
    return y_col


def _augment_cols(plan, lin, y_next, est_ind, x_aug, zi_aug):
    """One augmentation step, in place: the layer's output column of the
    augmented data rows and, sparse, of the inducing inputs."""
    col = (plan.m + lin["col"]).reshape(1)
    x_aug.index_copy_(1, col, y_next[:, None])
    if plan.sparse:
        zi_aug.index_copy_(1, col, est_ind[:, None])


def _augmented(plan, lin, y_next, est_ind, x_aug, zi_aug):
    """:func:`_augment_cols` out of place, for a chain that autograd
    differentiates through: layer ``l``'s Grams read the columns that the
    layers before it wrote, which depend on their latents.  Each layer gets
    a new buffer, so no write can reach a tensor that an earlier layer's
    operations saved for the backward.  A batched column (B, rows) gives
    batched inputs (B, rows, W)."""
    col = (plan.m + lin["col"]).reshape(1)

    def put(a, c):
        if a.ndim < c.ndim + 1:
            a = a.expand(*c.shape[:-1], *a.shape)
        return a.index_copy(-1, col, c[..., None])

    x_aug = put(x_aug, y_next)
    if plan.sparse:
        zi_aug = put(zi_aug, est_ind)
    return x_aug, zi_aug


def _chain_nll(plan, z_ext, xs, x, zi, n_layers, escalations=None):
    """The NLL of the chain's first ``n_layers`` layers from the raw inputs
    ``x`` (and inducing inputs ``zi``): per layer the masked layer NLL
    (:func:`_layer_nll_factors`), then one augmentation step out of place
    (:func:`_augmented`), so the value is differentiable end to end in
    ``z_ext``.  The chain of ``make_scan_logpdf_body`` (``n_layers = p``,
    under ``no_grad``) and of every objective of the free fit; (B,) for
    a batch of latents ``z_ext`` (B, n_z + 1)."""
    x_aug, zi_aug = _widen(x, plan.W), _widen(zi, plan.W)
    nlls = []
    for pi in range(n_layers):
        lin = {k: v[pi] for k, v in xs.items()}
        nll, factors = _layer_nll_factors(plan, lin, z_ext, x_aug, zi_aug, escalations)
        nlls.append(nll)
        if pi < n_layers - 1:
            est_rows, est_ind = _est_from_factors(plan, factors)
            x_aug, zi_aug = _augmented(plan, lin, _next_column(plan, lin, est_rows), est_ind,
                                       x_aug, zi_aug)
        del factors
    return torch.stack(nlls).sum(0)


class ScanStep:
    """The layer step of the scan-fused fit at uniform shapes: fixed-shape
    buffers and the bodies that work on them.

    Buffers: the stacked per-layer plan (model structure set once, row
    arrays loaded per fit), the current layer's slice ``lin`` and its index
    ``layer`` (on the device), the latents ``z_ext`` (dummy slot last), the
    augmented inputs, the layer's L-BFGS (``opt``, a
    :class:`~gpar_torch.params.lbfgs.DeviceLBFGS`), the per-layer results
    and ``escalations``, the count of Cholesky factorisations that needed
    more than the first jitter rung.
    The bodies read nothing back to the host; every factorisation in them
    takes the jitter ladder on the device
    (``ops.linalg.cholesky_ladder_on_device``), with the host ladder's
    value and gradient:

    - ``layer_init``: copy layer ``layer``'s plan slice, gather its
      latents, value and gradient there, an empty history;
    - ``step``, ``trial``, ``commit``: one L-BFGS iteration (see
      ``params/lbfgs.py``);
    - ``layer_finish``: the optimum (guarded) into ``z_ext``, the layer's
      results, and one augmentation step: the layer's posterior-mean
      estimates written into its output column of the augmented inputs;
      ``layer += 1``.

    With ``restarts = R > 1`` the optimiser is a
    :class:`~gpar_torch.params.lbfgs.BatchedDeviceLBFGS` over R starts of
    the layer's latents (the JAX package's ``lbfgs_traced_restarts`` in
    its scan body, ``gpar_tpu/models/fused.py:997-1006``): ``layer_init``
    starts element 0 at the gathered span and the others at the span plus
    the layer's row of ``pert`` (p, R - 1, s_max), the scaled normals
    loaded with the fit's inputs (dummy slots perturbed too, as in JAX;
    they feed only gated-out fields); ``layer_finish`` keeps the best
    finite optimum, chosen on the device, with element 0's initial NLL.
    """

    BODIES = ("layer_init", "step", "trial", "commit", "layer_finish")

    def __init__(self, plan, n_rows, n_ind, dtype, device, gtol=1e-9, memory_size=10,
                 restarts=1):
        self.plan, self.n_rows, self.n_ind = plan, n_rows, n_ind
        self.dtype, self.device = dtype, torch.device(device)
        self.gtol, self.memory_size, self.restarts = gtol, memory_size, restarts

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=self.device)

        self.xs = {}
        for k, v in plan_tensors(plan, dtype, self.device).items():
            self.xs[k] = zeros(plan.p, n_rows) if k in _ROW_KEYS else v
        self.lin = {k: torch.zeros_like(v[0]) for k, v in self.xs.items()}
        self.layer = zeros(1, dt=torch.int64)
        self.z_ext = zeros(plan.n_z + 1)
        self.x_aug = zeros(n_rows, plan.W)
        self.zi_aug = zeros(n_ind, plan.W)
        self.escalations = zeros(dt=torch.int64)
        self.pert = zeros(plan.p, restarts - 1, plan.s_max)
        if restarts > 1:
            self.opt = BatchedDeviceLBFGS(self._value_and_grad, self._value, restarts,
                                          plan.s_max, dtype, self.device, memory=memory_size,
                                          gtol=gtol)
        else:
            self.opt = DeviceLBFGS(self._value_and_grad, self._value, plan.s_max, dtype,
                                   self.device, memory=memory_size, gtol=gtol)
        self.out = zeros(3, plan.p)  # per layer: final NLL, initial NLL, iterations

    def _buffers(self):
        return [
            *self.xs.values(), *self.lin.values(), self.layer, self.z_ext, self.x_aug,
            self.zi_aug, self.escalations, self.pert, *self.opt.buffers(), self.out,
        ]

    def clone(self):
        """A step with copies of every buffer (a CUDA graph's warm-up runs
        on one, so that it moves none of this step's state)."""
        other = ScanStep(self.plan, self.n_rows, self.n_ind, self.dtype, self.device,
                         self.gtol, self.memory_size, self.restarts)
        for dst, src in zip(other._buffers(), self._buffers()):
            dst.copy_(src)
        return other

    def load(self, z_all, x, rows, x_ind, pert=None):
        """A fit's inputs: latents, (padded) data rows, their row arrays
        and the inducing inputs ((0, m) for a dense plan), and with
        restarts the perturbations of the starts, (p, R - 1, s_max); back
        to layer 0."""
        m = self.plan.m
        self.z_ext.zero_()
        self.z_ext[:-1].copy_(z_all)
        self.x_aug.zero_()
        self.x_aug[:, :m].copy_(x)
        self.zi_aug.zero_()
        self.zi_aug[:, :m].copy_(x_ind)
        for k in _ROW_KEYS:
            self.xs[k].copy_(rows[k])
        if self.restarts > 1:
            self.pert.copy_(pert)
        self.layer.zero_()
        self.escalations.zero_()

    # -- the layer objective ------------------------------------------------

    def _full(self, z):
        """``z_ext`` with the layer's latents set to ``z`` ((R, s_max): one
        row per start): a scatter that carries the gradient back to ``z``."""
        return _with_span(self.z_ext, self.lin["layer_gather"], z)

    def _nll_factors(self, z_full):
        return _layer_nll_factors(self.plan, self.lin, z_full, self.x_aug, self.zi_aug,
                                  self.escalations)

    def nll(self, z):
        return self._nll_factors(self._full(z))[0]

    def _value_and_grad(self, z):
        return _value_and_grad(self.nll, z)

    def _value(self, z):
        with torch.no_grad():
            return self.nll(z)

    # -- bodies -------------------------------------------------------------

    def layer_init(self):
        for k, buf in self.lin.items():
            buf.copy_(self.xs[k].index_select(0, self.layer)[0])
        z0 = self.z_ext.index_select(0, self.lin["layer_gather"])
        self.opt.start(_starts(z0, self.pert.index_select(0, self.layer)[0]))

    def step(self):
        self.opt.step()

    def trial(self):
        self.opt.trial()

    def commit(self):
        self.opt.commit()

    def layer_finish(self):
        z, f, f0, it = _optimum(self.opt)
        self.z_ext.index_put_((self.lin["layer_gather"],), z)
        self.z_ext[-1:].zero_()
        with torch.no_grad():
            # The output column written here is gated out of this layer's
            # kernel, so the estimates do not depend on it.
            est_rows, est_ind = _est_from_factors(self.plan, self._nll_factors(self.z_ext)[1])
        _augment_cols(self.plan, self.lin, _next_column(self.plan, self.lin, est_rows), est_ind,
                      self.x_aug, self.zi_aug)
        res = torch.stack([f, f0, it.to(f.dtype)])
        self.out.index_copy_(1, self.layer, res[:, None])
        self.layer.add_(1)

    def results(self, stats):
        """``(z_all, layer_nll, layer_iters, layer_nll0)`` after the last
        layer: the latents stay on the device; the per-layer results and
        the escalation count come back in one read
        (``stats["ladder_escalations"]``)."""
        stats["host_syncs"] += 1
        out = torch.cat([self.out.reshape(-1), self.escalations.to(self.out.dtype).reshape(1)]).cpu()
        out, stats["ladder_escalations"] = out[:-1].numpy().reshape(3, -1), int(out[-1])
        return self.z_ext[:-1].clone(), out[0], out[2].astype(np.int64), out[1]


def _with_span(z_ext, gather, z):
    """``z_ext`` with the entries ``gather`` set to ``z``: (d,), or one row
    per start (R, d), then (R, n_z + 1).  Padded gather slots all alias the
    dummy latent, which feeds only gated-out fields, so which of them wins
    does not matter."""
    if z.ndim == 1:
        return z_ext.index_put((gather,), z)
    R = z.shape[0]
    return z_ext.expand(R, -1).scatter(1, gather.expand(R, -1), z)


def _value_and_grad(nll, z):
    """Value and gradient of ``nll`` at ``z``; a batch of points (B, d)
    gives the (B,) values and each element's gradient."""
    z = z.detach().requires_grad_(True)
    with torch.enable_grad():
        f = nll(z)
        (g,) = torch.autograd.grad(f if f.ndim == 0 else f.sum(), z)
    return f.detach(), g


def _starts(z0, pert):
    """The starts of a fit: ``z0`` alone, or with restarts ``z0`` and
    ``z0 + pert[r]`` for each row of the scaled normals ``pert``."""
    if pert.shape[0] == 0:
        return z0
    return torch.cat([z0[None], z0[None] + pert])


def _optimum(opt):
    """``(z, f, f0, iterations)`` of an optimiser's end state: the
    guarded optimum, or, of a batch of starts, the best finite one (chosen
    on the device), with the unperturbed start's initial value."""
    z, f = opt.final()
    if z.ndim == 1:
        return z, f, opt.f0, opt.state.it
    best = best_of(f)
    pick = lambda a: a.index_select(0, best)[0]  # noqa: E731
    return pick(z), pick(f), opt.f0[0], pick(opt.state.it)


class Eager:
    """Runs a :class:`ScanStep`'s bodies now, without graphs."""

    replays = 0  # no graphs, no replays
    replayed = dict.fromkeys(GK.counters(), 0)

    def __init__(self, step):
        self.step = step

    def __call__(self, name):
        getattr(self.step, name)()


def run_scan_fit(step, run, iters, stats=None):
    """The loop over layers: per layer, ``layer_init``, up to ``iters``
    L-BFGS iterations and ``layer_finish``, each body run by ``run``
    (eagerly or from its graph).  The host reads the L-BFGS
    flags once per iteration (and per backtracking trial) and the results
    once at the end.  Returns :meth:`ScanStep.results`."""
    stats = new_stats() if stats is None else stats
    for _ in range(step.plan.p):
        run("layer_init")
        _iterations(run, step.opt, iters, stats)
        run("layer_finish")
    return step.results(stats)


def _iterations(run, opt, iters, stats):
    """Up to ``iters`` L-BFGS iterations of ``opt``, fewer if it converges."""
    for _ in range(iters):
        if iterate(run, opt, MAX_LINESEARCH, stats):
            break


def _inducing(x_ind, m, dtype, device):
    """The inducing inputs as a tensor; (0, m) for a dense plan."""
    if x_ind is None:
        return torch.zeros((0, m), dtype=dtype, device=device)
    return torch.as_tensor(x_ind, dtype=dtype, device=device)


@contextlib.contextmanager
def _cusolver(device):
    """cuSOLVER for the factorisations on the card (MAGMA's cannot be
    captured), for the eager and the graphed step alike."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _perturbations(normals, restarts, restart_scale, shape, like):
    """``restart_scale`` times the caller's standard normals ``shape``, or
    an empty (p, 0, .) tensor for a single start."""
    if restarts == 1:
        return like.new_zeros((shape[0], 0, shape[2]))
    if normals is None or tuple(normals.shape) != tuple(shape):
        got = None if normals is None else tuple(normals.shape)
        raise ValueError(f"restarts={restarts} needs standard normals of shape {tuple(shape)}, "
                         f"got {got}")
    return restart_scale * normals.to(like)


def make_scan_fit_body(plan, x_ind, iters, gtol, memory_size, restarts=1, restart_scale=1.0,
                       rows_traced=False, cuda_graphs=True):
    """The scan-fused whole-fit program ``(z_all, x, xs_rows=None,
    stats=None, normals=None) -> (z_final, layer_nll, layer_iters,
    layer_nll0)`` (the contract of ``gpar_tpu/models/fused.py:909-1047``
    without the mesh branch).  ``rows_traced``: ``x`` and ``xs_rows`` are
    bucket-padded (:func:`device_bucket_inputs`); otherwise ``x`` has the
    plan's exact rows.  ``restarts > 1``: each layer's L-BFGS runs from
    its latents and from ``restarts - 1`` perturbations of them,
    ``restart_scale`` times ``normals`` (p, restarts - 1, s_max), as one
    batch, and keeps the best (:class:`ScanStep`).  On a CUDA tensor with
    ``cuda_graphs`` the step's bodies replay CUDA graphs captured once per
    key (``models/graphs.py``); otherwise they run eagerly.  ``stats``
    (``params.lbfgs.new_stats()``) receives the counters,
    ``graph_replays``, ``replay_counts`` (what the replays added to the
    Gram counters) and ``capture_s``."""

    def program(z_all, x, xs_rows=None, stats=None, normals=None):
        stats = new_stats() if stats is None else stats
        dtype, device = x.dtype, x.device
        rows = xs_rows if rows_traced else plan_tensors(plan, dtype, device)
        zi = _inducing(x_ind, plan.m, dtype, device)
        pert = _perturbations(normals, restarts, restart_scale,
                              (plan.p, restarts - 1, plan.s_max), x)
        args = (z_all, x, rows, zi, pert)
        with _cusolver(device):
            if device.type == "cuda" and cuda_graphs:
                from .graphs import graphed_step

                step, run, capture_s = graphed_step(plan, x.shape[0], zi.shape[0], dtype, device,
                                                    iters, gtol, memory_size, args, restarts)
            else:
                step = ScanStep(plan, x.shape[0], zi.shape[0], dtype, device, gtol, memory_size,
                                restarts)
                step.load(*args)
                run, capture_s = Eager(step), 0.0
            replays0, replayed0 = run.replays, dict(run.replayed)
            out = run_scan_fit(step, run, iters, stats=stats)
        stats["graph_replays"] = run.replays - replays0
        stats["replay_counts"] = {k: v - replayed0[k] for k, v in run.replayed.items()}
        stats["capture_s"] = capture_s
        return out

    return program


def _prefix_gather(plan):
    """Per-position latent gathers of the free fit, ``(p, n_z)``: at
    position ``pi`` the spans of layers ``0..pi`` (the ``names=[f"{i}/*"
    for i in 0..pi]`` filter), padded with the dummy slot.  Spans are
    disjoint (``scale_tie``'s shared variable lives in layer 0's span), so
    a prefix is the concatenation of the layers' spans."""
    lg = np.asarray(plan.xs["layer_gather"])
    dummy = plan.n_z
    out = np.full((plan.p, plan.n_z), dummy, dtype=np.int64)
    for pi in range(plan.p):
        idx = np.concatenate([row[row != dummy] for row in lg[: pi + 1]])
        out[pi, : len(idx)] = idx
    return out


def make_scan_free_fit_body(plan, x_ind, iters, gtol, memory_size, restarts=1,
                            restart_scale=1.0, rows_traced=False):
    """The whole-fit program of ``fit(fix=False)`` (the contract of
    ``gpar_tpu/models/fused.py:1236-1390`` without the mesh branch):
    ``program(z_all, x, xs_rows=None, stats=None, normals=None) ->
    (z_final, layer_nll, layer_iters, layer_nll0)``.

    At position ``pi`` one L-BFGS (``params.lbfgs.DeviceLBFGS``, sized to
    ``plan.n_z``) minimises the NLL of the chain of layers ``0..pi`` from
    the raw inputs (:func:`_chain_nll`, the reference's full re-evaluation
    per objective call, ``gpar/regression.py:452-456``) jointly over their
    latents, gathered through :func:`_prefix_gather`; ``layer_nll[pi]`` is
    that prefix chain's NLL at the position's optimum.  Where the JAX
    package runs all p layers under a 0/1 contribution gate (one compiled
    body for every position), this loop runs ``pi + 1``: the same value,
    and the later layers never run.  Every factorisation takes the jitter
    ladder on the device, counted into ``stats["ladder_escalations"]``.

    The program runs eagerly, CUDA tensors included: the chain's length
    changes with the position, so no graph is captured.  ``rows_traced``
    as in :func:`make_scan_fit_body`; ``stats`` receives the L-BFGS
    counters, one host read for the results and ``graph_replays = 0``.

    ``restarts > 1``: at each position the L-BFGS runs from the prefix
    span's latents and from ``restarts - 1`` perturbations of the whole
    span (``gpar_tpu/models/fused.py:1360-1379``), ``restart_scale`` times
    ``normals`` (p, restarts - 1, n_z), as one batch whose chains are
    batched too; the best finite optimum is kept."""
    prefix = _prefix_gather(plan)

    def program(z_all, x, xs_rows=None, stats=None, normals=None):
        stats = new_stats() if stats is None else stats
        dtype, device = x.dtype, x.device
        with _cusolver(device):
            xs, z_ext = _serving_inputs(plan, z_all, x, xs_rows, rows_traced)
            zi = _inducing(x_ind, plan.m, dtype, device)
            gathers = torch.as_tensor(prefix, device=device)
            pert = _perturbations(normals, restarts, restart_scale,
                                  (plan.p, restarts - 1, plan.n_z), x)
            escalations = torch.zeros((), dtype=torch.int64, device=device)
            position = [0]

            def nll(z_sub):
                pi = position[0]
                z_full = _with_span(z_ext, gathers[pi], z_sub)
                return _chain_nll(plan, z_full, xs, x, zi, pi + 1, escalations)

            def value(z):
                with torch.no_grad():
                    return nll(z)

            args = (functools.partial(_value_and_grad, nll), value)
            if restarts > 1:
                opt = BatchedDeviceLBFGS(*args, restarts, plan.n_z, dtype, device,
                                         memory=memory_size, gtol=gtol)
            else:
                opt = DeviceLBFGS(*args, plan.n_z, dtype, device, memory=memory_size, gtol=gtol)
            out = torch.zeros((3, plan.p), dtype=dtype, device=device)
            for pi in range(plan.p):
                position[0] = pi
                opt.start(_starts(z_ext.index_select(0, gathers[pi]), pert[pi]))
                _iterations(Eager(opt), opt, iters, stats)
                z, f, f0, it = _optimum(opt)
                z_ext.index_put_((gathers[pi],), z)
                z_ext[-1:].zero_()
                out[:, pi] = torch.stack([f, f0, it.to(dtype)])
            stats["host_syncs"] += 1
            res = torch.cat([out.reshape(-1), escalations.to(dtype).reshape(1)]).cpu()
        per_pos, stats["ladder_escalations"] = res[:-1].numpy().reshape(3, -1), int(res[-1])
        stats.update(graph_replays=0, replay_counts=dict.fromkeys(GK.counters(), 0), capture_s=0.0)
        return z_ext[:-1].clone(), per_pos[0], per_pos[2].astype(np.int64), per_pos[1]

    return program


def make_batched_fit_body(plan, iters, gtol, memory_size, restarts=1, restart_scale=1.0,
                          rows_traced=False):
    """All p layers' fits as one batched L-BFGS, ``fused="batched"``
    (``gpar_tpu/models/fused.py:1146-1234``): ``program(z_all, x,
    xs_rows=None, stats=None, normals=None) -> (z_final, layer_nll,
    layer_iters, layer_nll0)``.

    The layers are independent when no estimate feeds forward, which holds
    for exactly the JAX package's preconditions, checked here with its
    messages: a dense model, ``replace=False``, ``scale_tie=False`` and
    fully observed data.  Then every layer's objective reads only its own
    latent span and the raw data: the augmented inputs are the observed
    outputs, filled once (the gates hide the columns a layer may not see),
    and the p layers times ``restarts`` starts (``restart_scale`` times
    ``normals`` (p, restarts - 1, s_max)) are one batch of p R elements,
    each with its own plan slice.  Every evaluation is one batched Gram
    launch (and, for the gradient, one batched backward launch) and one
    batched factorisation.  Each layer keeps its best finite start; the
    spans are scattered back and the dummy slot re-zeroed.  It runs
    eagerly: one L-BFGS over the batch, its host reads one per iteration
    and round of backtracking trials.  ``rows_traced`` as in
    :func:`make_scan_fit_body`."""
    if plan.sparse:
        raise ValueError("batched layer fits require a dense model")
    if plan.replace:
        raise ValueError("batched layer fits require replace=False")
    if plan.config["scale_tie"]:
        raise ValueError("batched layer fits require scale_tie=False")
    if not np.all(np.asarray(plan.xs["avail"]) == 1.0):
        raise ValueError("batched layer fits require fully-observed data")
    p, R, s_max = plan.p, restarts, plan.s_max

    def program(z_all, x, xs_rows=None, stats=None, normals=None):
        stats = new_stats() if stats is None else stats
        dtype, device = x.dtype, x.device
        with _cusolver(device):
            xs, z_ext = _serving_inputs(plan, z_all, x, xs_rows, rows_traced)
            x_aug = torch.cat([x, xs["y_col"].T], dim=1)  # (rows, W): every output column
            zi_aug = x_aug.new_zeros((0, plan.W))
            lin = {k: v.repeat_interleave(R, dim=0) for k, v in xs.items()}  # element pi R + r
            gather = lin["layer_gather"]
            pert = _perturbations(normals, R, restart_scale, (p, R - 1, s_max), x)
            z0 = z_ext[xs["layer_gather"]]  # (p, s_max)
            starts = torch.cat([z0[:, None], z0[:, None] + pert], dim=1).reshape(p * R, s_max)
            escalations = torch.zeros((), dtype=torch.int64, device=device)

            def nll(z):
                z_full = z_ext.expand(p * R, -1).scatter(1, gather, z)
                return _layer_nll_factors(plan, lin, z_full, x_aug, zi_aug, escalations)[0]

            def value(z):
                with torch.no_grad():
                    return nll(z)

            opt = BatchedDeviceLBFGS(functools.partial(_value_and_grad, nll), value, p * R, s_max,
                                     dtype, device, memory=memory_size, gtol=gtol)
            opt.start(starts)
            _iterations(Eager(opt), opt, iters, stats)
            z, f = opt.final()
            f = f.reshape(p, R)
            best = torch.argmin(torch.where(torch.isfinite(f), f, torch.inf), dim=1)
            rows = torch.arange(p, device=device)
            z_best = z.reshape(p, R, s_max)[rows, best]
            z_ext.scatter_(0, xs["layer_gather"].reshape(-1), z_best.reshape(-1))
            z_ext[-1:].zero_()
            its = opt.state.it.reshape(p, R)[rows, best]
            out = torch.stack([f[rows, best], opt.f0.reshape(p, R)[:, 0], its.to(dtype)])
            stats["host_syncs"] += 1
            res = torch.cat([out.reshape(-1), escalations.to(dtype).reshape(1)]).cpu()
        per_layer, stats["ladder_escalations"] = res[:-1].numpy().reshape(3, -1), int(res[-1])
        stats.update(graph_replays=0, replay_counts=dict.fromkeys(GK.counters(), 0), capture_s=0.0)
        return z_ext[:-1].clone(), per_layer[0], per_layer[2].astype(np.int64), per_layer[1]

    return program


def _widen(a, W):
    """``a`` (n, m) with zero columns appended to the augmented width W."""
    return torch.cat([a, a.new_zeros((a.shape[0], W - a.shape[1]))], dim=1)


def _serving_inputs(plan, z_all, x, xs_rows, rows_traced):
    """The plan's arrays on ``x``'s device (the bucketed row arrays
    ``xs_rows`` in place of the plan's own when ``rows_traced``) and the
    latent vector extended by the dummy slot."""
    xs = plan_tensors(plan, x.dtype, x.device, rows=xs_rows if rows_traced else None)
    return xs, torch.cat([z_all, z_all.new_zeros(1)])


def _layer_kernels(plan, z_ext, xs):
    """Every layer's plan slice, kernel and noise at the latents ``z_ext``:
    yields ``(lin, kernel, noise)``, nothing conditioned."""
    for pi in range(plan.p):
        lin = {k: v[pi] for k, v in xs.items()}
        yield (lin, *_layer_kernel(plan, lin, z_ext))


def _condition_layers(plan, x_ind, z_ext, x, xs):
    """The training chain of the serving tails, one layer at a time: the
    layer's posterior factors on its masked training rows at the final
    hyperparameters, then one augmentation step (impute/replace rules).
    Yields ``(lin, kernel, noise, factors)``, the factors those of
    ``gpar_tpu/models/fused.py:1858-1950``: sparse ``{zi_aug, Lm, LB,
    beta}`` (the augmented inducing inputs at the layer's entry), dense
    ``{x_aug, alpha, L}`` (the augmented training rows at its entry)."""
    dtype, device = x.dtype, x.device
    x_aug, zi_aug = _widen(x, plan.W), _widen(_inducing(x_ind, plan.m, dtype, device), plan.W)
    eps = resolve_epsilon(dtype)
    for lin, kernel, noise in _layer_kernels(plan, z_ext, xs):
        noise_w = floor_noise(noise / lin["w_col"])
        omask, r = lin["obs_mask"], lin["y_col"]
        if plan.sparse:
            Kmm = gram(kernel, zi_aug, zi_aug)
            Kmn = gram(kernel, zi_aug, x_aug)
            knn = kdiag(kernel, x_aug)
            _, Lm, LB, beta = titsias_factors(Kmm, Kmn, knn, r, torch.zeros_like(r), noise_w,
                                              mask=omask)
            fac = {"zi_aug": zi_aug.clone(), "Lm": Lm, "LB": LB, "beta": beta}
            est_rows, est_ind = Kmn.T @ beta, Kmm @ beta
        else:
            K = gram(kernel, x_aug, x_aug)
            _, alpha, L = _masked_dense_factors(K, r, omask, noise_w, eps)
            fac = {"x_aug": x_aug.clone(), "alpha": alpha, "L": L}
            est_rows, est_ind = K @ alpha, None
            del K
        yield lin, kernel, noise, fac
        _augment_cols(plan, lin, _next_column(plan, lin, est_rows), est_ind, x_aug, zi_aug)


def factor_slices(stack):
    """The layers of a stacked factor dict (:func:`make_scan_posterior_factors`)
    one at a time, as :func:`posterior_factor_layers` yields them: the
    form every tail that takes factors consumes."""
    p = next(iter(stack.values())).shape[0]
    return ({k: v[pi] for k, v in stack.items()} for pi in range(p))


def posterior_factor_layers(plan, x_ind, rows_traced=False):
    """``factors(z_all, x, xs_rows=None)``: an iterator over the layers'
    posterior factors (dicts as in :func:`make_scan_posterior_factors`),
    each computed when it is asked for: the factors of the per-sample
    tail, which never holds more than one layer's.  Consume it under
    ``torch.no_grad()``."""

    def factors(z_all, x, xs_rows=None):
        xs, z_ext = _serving_inputs(plan, z_all, x, xs_rows, rows_traced)
        return (fac for _, _, _, fac in _condition_layers(plan, x_ind, z_ext, x, xs))

    return factors


def make_scan_posterior_factors(plan, x_ind, rows_traced=False):
    """Per-layer posterior factors, stacked over the layers
    (``gpar_tpu/models/fused.py:1858-1950``): ``factors(z_all, x,
    xs_rows=None) -> dict`` of sparse ``zi_aug`` (p, M, W), ``Lm``/``LB``
    (p, M, M) and ``beta`` (p, M), or dense ``x_aug`` (p, n, W), ``alpha``
    (p, n) and ``L`` (p, n, n).  They depend on the hyperparameters and the
    conditioning data only, not on the test points."""
    layers = posterior_factor_layers(plan, x_ind, rows_traced)

    def factors(z_all, x, xs_rows=None):
        with torch.no_grad(), _cusolver(x.device):
            out = list(layers(z_all, x, xs_rows))
            return {k: _stack_layout(*[f[k] for f in out]) for k in out[0]}

    return factors


def _stack_layout(*ts):
    """``torch.stack(ts)`` whose slices keep the layout of ``ts``: a
    column-major matrix (a Cholesky factor) stays column-major, so the
    solves against a slice take the same library path, and give the same
    bits, as against the factor itself."""
    t = ts[0]
    if t.ndim == 2 and t.shape[0] > 1 and t.stride() == (1, t.shape[0]):
        return torch.stack([a.mT for a in ts]).mT
    return torch.stack(ts)


def make_scan_logpdf_body(plan, x_ind, rows_traced=False):
    """The prior log-density of a dataset (``gpar_tpu/models/fused.py:
    1489-1555``, single device): ``program(z_all, x, xs_rows=None) ->
    scalar``, the chain accumulation of ``GPAR.logpdf``
    (``gpar/model.py:178-243``) at uniform shapes.  It is the fixed fit's
    chain without the L-BFGS: per layer the masked layer NLL at the given
    latents, then one augmentation step; the score is minus the sum of the
    layer NLLs (:func:`_chain_nll` over all p layers, under ``no_grad``).
    ``plan`` is the scored data's (:func:`build_scan_data_plan`);
    ``rows_traced`` as in :func:`make_scan_fit_body`."""

    def program(z_all, x, xs_rows=None):
        with torch.no_grad(), _cusolver(x.device):
            xs, z_ext = _serving_inputs(plan, z_all, x, xs_rows, rows_traced)
            zi = _inducing(x_ind, plan.m, x.dtype, x.device)
            return -_chain_nll(plan, z_ext, xs, x, zi, plan.p)

    return program


def make_scan_posterior_logpdf_tail(plan, x_ind, rows_traced=False):
    """The posterior log-density of new data (``gpar_tpu/models/fused.py:
    1630-1790``, single device): ``tail(z_all, factors, x, xs_rows=None,
    tr_mask=None) -> scalar``.  ``plan`` is the scored data's plan and
    ``factors`` yields the training chain's per-layer posterior factors in
    turn (:func:`posterior_factor_layers`).  Per layer the GP core's nested
    conditioning (``gp/core.py``), at uniform shapes:

    - sparse: the Titsias factors of the posterior prior, whose mean and
      covariances come from the training factors (``SparsePosteriorGP``),
      at the scoring chain's own augmented inducing inputs, which restart
      from ``x_ind`` (``gpar/model.py:199,251``), not at the training
      chain's (``fac["zi_aug"]``);
    - dense: the masked exact likelihood of the residual under the
      posterior at the scored rows.  The training factors were computed
      with the training chain's masked rows made identity rows, so the
      cross-covariance is masked by ``tr_mask`` (p, n_train), the
      training chain's per-layer ``obs_mask``, not by the scored plan's.

    The augmentation feeds the posterior of the layer given the scored
    observations forward (``condition(f_post, obs_new).mean``)."""

    def tail(z_all, factors, x, xs_rows=None, tr_mask=None):
        if not plan.sparse and tr_mask is None:
            raise ValueError("make_scan_posterior_logpdf_tail: dense factors need the training "
                             "chain's per-layer observation masks (tr_mask)")
        dtype, device = x.dtype, x.device
        with torch.no_grad(), _cusolver(device):
            xs, z_ext = _serving_inputs(plan, z_all, x, xs_rows, rows_traced)
            x_aug = _widen(x, plan.W)
            zi_aug = _widen(_inducing(x_ind, plan.m, dtype, device), plan.W)
            eps = resolve_epsilon(dtype)
            nlls = []
            for pi, fac in zip(range(plan.p), factors):
                lin = {k: v[pi] for k, v in xs.items()}
                kernel, noise = _layer_kernel(plan, lin, z_ext)
                noise_w = floor_noise(noise / lin["w_col"])
                omask, r = lin["obs_mask"], lin["y_col"]
                if plan.sparse:
                    Km_x = gram(kernel, fac["zi_aug"], x_aug)
                    Km_z = gram(kernel, fac["zi_aug"], zi_aug)
                    T1x = solve_lower(fac["Lm"], Km_x)
                    T2x = solve_lower(fac["LB"], T1x)
                    T1z = solve_lower(fac["Lm"], Km_z)
                    T2z = solve_lower(fac["LB"], T1z)
                    mean_x, mean_z = Km_x.T @ fac["beta"], Km_z.T @ fac["beta"]
                    Kmm_p = gram(kernel, zi_aug, zi_aug) - T1z.T @ T1z + T2z.T @ T2z
                    Kmn_p = gram(kernel, zi_aug, x_aug) - T1z.T @ T1x + T2z.T @ T2x
                    knn_p = (kdiag(kernel, x_aug) - torch.sum(T1x * T1x, dim=0)
                             + torch.sum(T2x * T2x, dim=0))
                    elbo, _, _, beta_n = titsias_factors(Kmm_p, Kmn_p, knn_p, r, mean_x, noise_w,
                                                         mask=omask)
                    nlls.append(-elbo)
                    est_rows, est_ind = mean_x + Kmn_p.T @ beta_n, mean_z + Kmm_p @ beta_n
                else:
                    Kxt = gram(kernel, fac["x_aug"], x_aug).mul_(tr_mask[pi][:, None])
                    mean_x = Kxt.T @ fac["alpha"]
                    V = solve_lower(fac["L"], Kxt)
                    del Kxt
                    Kp = gram(kernel, x_aug, x_aug) - V.T @ V
                    del V
                    lp, alpha_n, _ = _masked_dense_factors(Kp, (r - mean_x) * omask, omask,
                                                           noise_w, eps)
                    nlls.append(-lp)
                    est_rows, est_ind = mean_x + Kp @ alpha_n, None
                    del Kp
                _augment_cols(plan, lin, _next_column(plan, lin, est_rows), est_ind, x_aug, zi_aug)
            return -torch.stack(nlls).sum()

    return tail


def _solve_shared(L, B):
    """``L^{-1} B`` for one lower-triangular ``L`` (n, n) and ``B`` (n, k) or
    (S, n, k).  With a sample axis it is one solve against the (n, S k)
    right-hand side: ``solve_triangular`` would broadcast ``L`` over the
    samples (a copy of a dense (n, n) factor per sample)."""
    if B.ndim == 2:
        return solve_lower(L, B)
    S, n, k = B.shape
    return solve_lower(L, B.transpose(0, 1).reshape(n, S * k)).reshape(n, S, k).transpose(0, 1)


def _test_posterior(plan, kernel, lin, fac, xt, mt):
    """A layer's posterior mean (..., n_test) and covariance (..., n_test,
    n_test) at the test inputs ``xt`` (n_test, W), or (S, n_test, W) with a
    sample axis (each Gram one launch for all S): sparse through
    ``gp/core.SparsePosteriorGP``'s algebra, dense through
    ``PosteriorGP``'s, where a masked training row has ``alpha`` 0 and an
    identity row in ``L``, so zeroing its cross-covariance row conditions on
    the observed rows only.  Padded test rows (``mt``) are neutralised."""
    if plan.sparse:
        Kmt = gram(kernel, fac["zi_aug"], xt)  # (..., M, n_test)
        mean = Kmt.mT @ fac["beta"]
        T1 = _solve_shared(fac["Lm"], Kmt)
        T2 = _solve_shared(fac["LB"], T1)
        cov = gram(kernel, xt, xt) - T1.mT @ T1 + T2.mT @ T2
    else:
        Kxt = gram(kernel, fac["x_aug"], xt).mul_(lin["obs_mask"][:, None])  # (..., n, n_test)
        mean = Kxt.mT @ fac["alpha"]
        V = _solve_shared(fac["L"], Kxt)
        del Kxt
        cov = gram(kernel, xt, xt) - V.mT @ V
    return mean, _mask_test_cov(cov, mt)


def make_scan_predict_tail(plan, x_ind, latent, rows_traced=False):
    """Posterior conditioning and Monte-Carlo predictive sampling over the
    layers, ``replace=True`` (``gpar_tpu/models/fused.py:2275-2429``): per
    layer the Titsias or exact factors on the masked training rows at the
    final hyperparameters, the posterior mean and covariance at the test
    rows, one sampling factor, all draws as one matmul, then one
    augmentation step of the training inputs (impute/replace rules) and of
    the test inputs (the posterior mean).  On the card the factorisations
    are cuSOLVER's, as in the fit.

    Returns ``tail(z_all, x, x_test, w_test_T, normals, xs_rows=None,
    mt=None) -> (batch, mean_chain)``: ``normals`` (p, S, n_test) are the
    standard normals of the draws (JAX's per-sample key stream becomes
    caller-supplied draws), ``mt`` the test-row mask of a bucketed call;
    ``batch`` (S, n_test, p) model-space samples, ``mean_chain`` (n_test,
    p) the per-layer posterior means fed forward."""
    if not plan.replace:
        raise ValueError("make_scan_predict_tail requires replace=True chains.")

    def tail(z_all, x, x_test, w_test_T, normals, xs_rows=None, mt=None):
        with torch.no_grad(), _cusolver(x.device):
            xs, z_ext = _serving_inputs(plan, z_all, x, xs_rows, rows_traced)
            layers = _condition_layers(plan, x_ind, z_ext, x, xs)
            return _predict_chain(plan, latent, layers, x_test, w_test_T, normals, mt)

    return tail


def make_scan_cached_tail(plan, latent, rows_traced=False):
    """The ``replace=True`` predictive from cached factors
    (``gpar_tpu/models/fused.py:1953-2040``): the test-point half of
    :func:`make_scan_predict_tail`.  Each call rebuilds the layer kernels
    from the latent vector; only the conditioning factors are reused, so
    given the same normals the draws are the same operations, and on one
    device the same bits, as that tail's.

    Returns ``tail(z_all, factors, x_test, w_test_T, normals, xs_rows=None,
    mt=None) -> (batch, mean_chain)``: ``factors`` the stacked dict of
    :func:`make_scan_posterior_factors`, ``xs_rows`` the training data's
    bucketed row arrays (a dense layer masks its cross-covariance by their
    ``obs_mask``); the rest as in :func:`make_scan_predict_tail`."""
    if not plan.replace:
        raise ValueError("make_scan_cached_tail requires replace=True chains.")

    def tail(z_all, factors, x_test, w_test_T, normals, xs_rows=None, mt=None):
        with torch.no_grad(), _cusolver(x_test.device):
            xs, z_ext = _serving_inputs(plan, z_all, x_test, xs_rows, rows_traced)
            layers = ((*layer, fac) for layer, fac in zip(_layer_kernels(plan, z_ext, xs),
                                                          factor_slices(factors)))
            return _predict_chain(plan, latent, layers, x_test, w_test_T, normals, mt)

    return tail


def _predict_chain(plan, latent, layers, x_test, w_test_T, normals, mt):
    """The ``replace=True`` draws of both predict tails: per layer of
    ``layers`` (``(lin, kernel, noise, factors)``) the posterior at the
    test rows, one sampling factor, all draws as one matmul, and the
    posterior mean fed forward to the test inputs."""
    xt_aug = _widen(x_test, plan.W)
    ys, means = [], []
    for pi, (lin, kernel, noise, fac) in enumerate(layers):
        mean_t, cov_t = _test_posterior(plan, kernel, lin, fac, xt_aug, mt)
        if not latent:
            cov_t = cov_t + torch.diag(floor_noise(noise / w_test_T[pi]))
        F = psd_sample_factor(cov_t)
        ys.append(mean_t[None, :] + normals[pi] @ F.T)  # (S, n_test)
        means.append(mean_t)
        xt_aug.index_copy_(1, (plan.m + lin["col"]).reshape(1), mean_t[:, None])
    return torch.stack(ys, dim=-1), torch.stack(means, dim=-1)


def resolve_sample_chunk(sample_chunk, num_samples, n_test, dtype, budget):
    """The sample-axis chunk of the per-sample tails
    (``gpar_tpu/models/fused.py:855-871``): ``"auto"`` sizes it so that four
    (chunk, n_test, n_test) buffers of ``dtype`` (the batched covariance,
    its sampling factor and the ladder's temporaries) fit ``budget`` bytes;
    an integer passes through; ``None`` or 0 takes no chunks.  None where
    the whole batch fits."""
    if sample_chunk == "auto":
        per_sample = 4 * n_test * n_test * dtype.itemsize
        chunk = max(1, int(budget // max(per_sample, 1)))
        return None if chunk >= num_samples else chunk
    if not sample_chunk:
        return None
    return int(sample_chunk)


def _chunked_batch(batch_fn, num_samples, sample_chunk):
    """``batch_fn(samples)`` over slices of the sample axis of at most
    ``sample_chunk`` samples (all at once for None), concatenated: the peak
    memory of a layer is that of one chunk.  Every sample's arithmetic is
    its own, so chunked draws equal unchunked ones."""
    if sample_chunk is None or sample_chunk >= num_samples:
        return batch_fn(slice(0, num_samples))
    return torch.cat([batch_fn(slice(s, s + sample_chunk))
                      for s in range(0, num_samples, sample_chunk)])


def _ancestral(plan, latent, sample_chunk, z_ext, xs, layers, x_test, w_test_T, normals,
               noise_normals, mt):
    """Per-sample ancestral chains (``_sample_chain``,
    ``gpar/model.py:245-277``): every sample carries its own augmented test
    inputs, so every layer takes, per chunk of samples, the batched Gram,
    the posterior at each sample's inputs (zero mean and the prior
    covariance where ``layers`` yields None), the floored noise on the
    diagonal of an observed draw, one batched sampling factor and the
    draws.  A latent draw returns the noiseless sample and feeds forward
    the noisy one with UNfloored noise, ``sqrt(noise / w)``; the column fed
    forward is the mean under ``replace``, the draw otherwise."""
    S, nt = normals.shape[1], x_test.shape[0]
    xt_b = _widen(x_test, plan.W).expand(S, nt, plan.W).contiguous()
    if latent and not plan.replace and noise_normals is None:
        raise ValueError("latent draws that feed forward need noise_normals")
    cols = []
    for pi, fac in zip(range(plan.p), layers):
        lin = {k: v[pi] for k, v in xs.items()}
        kernel, noise = _layer_kernel(plan, lin, z_ext)
        col = (plan.m + lin["col"]).reshape(1)
        w_t = w_test_T[pi]

        def batch(sl, lin=lin, kernel=kernel, noise=noise, fac=fac, col=col, w_t=w_t):
            xt = xt_b[sl]
            if fac is None:
                cov = _mask_test_cov(gram(kernel, xt, xt), mt)
                mean = cov.new_zeros(cov.shape[:-1])
            else:
                mean, cov = _test_posterior(plan, kernel, lin, fac, xt, mt)
            if not latent:
                cov.diagonal(dim1=-2, dim2=-1).add_(floor_noise(noise / w_t))
            F = psd_sample_factor_batched(cov)
            del cov
            draw = mean + (F @ normals[pi, sl, :, None])[..., 0]
            if plan.replace:
                nxt = mean
            elif latent:
                nxt = draw + torch.sqrt(noise / w_t) * noise_normals[pi, sl]
            else:
                nxt = draw
            xt.index_copy_(2, col, nxt[..., None])
            return draw

        cols.append(_chunked_batch(batch, S, sample_chunk))
    return torch.stack(cols, dim=-1)


def make_scan_ancestral_tail(plan, latent, sample_chunk=None, rows_traced=False):
    """Per-sample ancestral chains from posterior factors, the tail of
    ``replace=False`` prediction and posterior sampling
    (``gpar_tpu/models/fused.py:2042-2176``): with ``replace=False`` the
    sampled output feeds the next layer's inputs, so every sample has its
    own per-layer posterior covariance (:func:`_ancestral`).  The sample
    axis runs in chunks of ``sample_chunk`` (:func:`resolve_sample_chunk`).

    Returns ``tail(z_all, factors, x_test, w_test_T, normals,
    noise_normals=None, xs_rows=None, mt=None) -> batch`` (S, n_test, p)
    model-space samples.  ``factors`` yields each layer's posterior
    factors in turn (:func:`posterior_factor_layers`); ``normals`` (p, S, n_test) are the
    draws' standard normals and ``noise_normals`` (p, S, n_test) those of
    the noise a latent draw feeds forward (JAX's ``k1`` and ``k2`` keys per
    sample and layer)."""

    def tail(z_all, factors, x_test, w_test_T, normals, noise_normals=None, xs_rows=None,
             mt=None):
        with torch.no_grad(), _cusolver(x_test.device):
            xs, z_ext = _serving_inputs(plan, z_all, x_test, xs_rows, rows_traced)
            return _ancestral(plan, latent, sample_chunk, z_ext, xs, factors, x_test, w_test_T,
                              normals, noise_normals, mt)

    return tail


def build_scan_prior_plan(reg, m, p, all_names, dtype):
    """The plan of prior sampling (``gpar_tpu/models/fused.py:520-540``):
    the model-structure arrays only (no conditioning data, ``n = 0``)."""
    xs, s_max, n_z = _kernel_field_xs(reg.vs, all_names, m, p, m + p, reg.model_config,
                                      np.dtype(dtype))
    return ScanFitPlan(
        m=m, p=p, W=m + p, n=0, s_max=s_max, n_z=n_z, xs=xs, config=dict(reg.model_config),
        sparse=reg.sparse, impute=bool(reg.impute), replace=bool(reg.replace),
    )


def make_scan_prior_tail(plan, latent, sample_chunk=None):
    """Per-sample prior ancestral chains (``gpar_tpu/models/fused.py:
    2179-2272``): :func:`_ancestral` with zero-mean layers, whose inducing
    points play no part.  Returns ``tail(z_all, x_test, w_test_T, normals,
    noise_normals=None, mt=None) -> batch`` (S, n_test, p), arguments as in
    :func:`make_scan_ancestral_tail`."""

    def tail(z_all, x_test, w_test_T, normals, noise_normals=None, mt=None):
        with torch.no_grad(), _cusolver(x_test.device):
            xs, z_ext = _serving_inputs(plan, z_all, x_test, None, False)
            return _ancestral(plan, latent, sample_chunk, z_ext, xs, [None] * plan.p, x_test,
                              w_test_T, normals, noise_normals, mt)

    return tail
