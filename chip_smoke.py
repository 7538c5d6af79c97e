#!/usr/bin/env python3
"""Smoke test of gpar_torch on one CUDA card.

    python3 chip_smoke.py [--profile DIR] [--kernels-only]

Phases (each raises on failure; the script exits 0 only if all pass):

1. Device and build: requires CUDA, prints the card's name and power
   limit, builds the hand-written kernels (forward and backward, one
   source, one ``nvcc``) from the sources in the checkout.
2. Kernel check: the CUDA Gram kernel and the CUDA Gram backward kernel
   against their plain PyTorch versions on the card, on the benchmark's
   layer kernels at the main path's shapes — (256, 256), (256, 10000),
   (256, 1024), (1024, 1024), input widths 1 and 16 — plus the scan
   path's gated layer kernel (width W = m + p = 17, three terms) at its
   shapes: Kmn (256, 11840), Kmm (256, 256), Kmt (256, 1216) and the test
   covariance (1216, 1216); a ragged (37, 23) shape, a tree of 264
   features (one term of 120), wider than the kernels' staging chunks, at
   (37, 23) and (256, 1024), and a tree whose terms sit at the edges of the
   backward's lane maps (rbf 2, rq 15, lin 17, rq 33, rbf 64 features) at
   (37, 23), (300, 133) and (256, 11840); and the dense path's (no inducing
   points) shapes of the gated kernel, K (11840, 11840) and the test
   cross-covariance (11840, 1216), and the ``[mesh]`` phase's per-shard
   shapes, Kmn (256, 2960) and the dense rows (768, 3072), all held
   against the plain versions (the dense ones run in
   1024-row blocks in float64: the plain Gram builds an (n, m, d)
   difference tensor).  Forward: rtol/atol 1e-5 in float32, 1e-12 in
   float64.  Backward: max |err| / max |plain| at most 1e-4 in float32 (its
   10 000-long sums run in another order) and 1e-10 in float64; two
   backward launches at (256, 11840) and at (11840, 11840) must give the
   same bits, and the backward's plan there is printed.  The
   gradient of the fused Gram against autograd of the plain recursion run
   in float64 (on the upcast inputs in the float32 case): max |err| /
   max |ref| at most 1e-10 in float64 and 1e-5 in float32.  Device times of
   kernels and plain versions (``torch.profiler``) beside the card's bound.
   Then the Gram with a sample axis (one launch for S Grams, the per-sample
   tails' route) on the gated kernel at (S=90, 256, 1216) with the left
   operand shared, (90, 1216, 1216) and the dense (90, 11840, 1216) with the
   left operand shared (the chunk the tails launch), every sample against
   its plain version (at the dense shape in 1024-row blocks in float64),
   1e-5 / 1e-12; its time
   beside S separate 2-D launches of the same Grams and its bound.  The
   scored data's shapes (2000 rows, bucket 2432) forward only, (256,
   2432), (11840, 2432) and (2432, 2432), against the plain version in
   float64 row blocks, timed; and the gradient of a Gram of one input
   tensor on both sides whose columns were written out of place from a
   tensor that requires a gradient (the joint fit's Grams), at (256, 256)
   and (2432, 2432), against the float64 recursion (1e-10 / 1e-4).
   Then both kernels over a batch of per-element trees (the restarts' and
   ``fused="batched"``'s Grams: features and parameters carry the batch) at
   (4, 256, 11840), (4, 256, 256) and (64, 2432, 2432), and at the first
   with the left operand shared, every element against its plain version in
   float64 (forward 1e-5 / 1e-12, backward 1e-4 / 1e-10 of the largest
   entry), two launches of each giving the same bits; in float32 each
   timed beside B separate 2-D launches, the plain version and B times the
   single Gram's bound.  The same for the greedy scorer's Grams at its
   first position: the estimator's layer-0 tree over 16 candidates at
   (16, 256, 11840), with the left operand shared too, and (16, 2432, 2432).
3. Main path at full width: ``GPARRegressor.fit_predict`` at the
   benchmark's configuration (``bench.py``): n=10 000, p=16, 256 inducing
   points, 10 L-BFGS iterations per layer, 100-sample predictive with
   credible bounds at 1024 test inputs, float32, jitter 1e-6, through the
   scan-fused path (rows bucketed to 11 840, test rows to 1216), its layer
   step captured once as CUDA graphs and replayed for every layer and
   iteration; held to the benchmark's ``10k`` quality gates; every Gram
   must have gone through the kernel (no plain-route Gram, no
   ``gram_eval`` on the card), every Gram taken under autograd through the
   backward kernel, and the fit must have replayed the step's graphs.  Cold
   (captures included) and warm wall-clocks; the two runs must give
   identical results (no atomics); the host reads are held to one per
   L-BFGS iteration, backtracking trial and episode, and one per fit.
   Then the same fit with the step run eagerly on the card
   (``cuda_graphs=False``), which
   must give the graphed run's bits, and the per-layer driver
   (``fused=False``), which must pass the gates too.  Each run prints its
   fit and predict wall-clocks and its peak device memory.
4. The dense path at full width (``[dense]`` lines): the same request and
   the same checks with ``x_ind=None`` (no inducing points: the exact
   marginal likelihood over the (11840, 11840) bucketed rows, every Gram of
   the fit at that shape), and the memory the cached graphed step pins;
   then one evaluation of the dense layer objective under
   ``torch.profiler``, with the scan step's on-device Cholesky ladder and
   with the per-layer driver's host ladder: the factorisations (cuSOLVER
   ``potrf``) each runs and their device time.  The dense eager step and
   per-layer driver run at n = 4000 (bucket 4800), held to a graphed run
   at that size (the same bits; the driver's sum of layer NLLs within
   1e-3), not to the ``10k`` gates.
5. Per-sample ancestral sampling at full width (``[ancestral]`` lines): the
   benchmark's request with ``replace=False`` (sparse, cold and warm, held
   to the ``10k`` gates; then ``latent=True``), posterior ``sample`` of it
   and of phase 3's ``replace=True`` model and a prior ``sample`` (p=16),
   100 samples at the 1024 test inputs, and the dense model once (its
   stack is over the cache's limit, so its tail factors each layer in its
   loop); every run's fit and predict wall-clock, peak device memory and
   launch counts (batched launches > 0 where samples carry their own
   inputs, no plain-route Gram, no ``gram_eval`` on the card); one
   profiled ``predict`` of each model, device time by operator.
6. The log-density (``[logpdf]`` lines, :func:`phase_logpdf`): the bench's
   serving score, a fresh 2000-row dataset under the prior and the
   posterior of phase 3's and phase 4's models, cold and warm, through the
   scan routes; against float64 on the card and the float64 GP-core
   route; ``sample_missing``; and the training identity ``logpdf(x, y) ==
   -sum(layer_nll)`` of a ``fix=True`` fit.
7. The joint fit (``[free]`` lines, :func:`phase_free`): ``fit(fix=False)``
   of the sparse bench model at full width against the ``10k`` SMSE gates,
   its last position's NLL equal to ``-logpdf``; the dense one at n = 2000,
   p = 4.
8. Multi-start fits (``[restarts]`` lines, :func:`phase_restarts`): the
   bench's request with ``restarts=4``, graphed, cold and warm (the ``10k``
   gates, identical runs, the sum of layer NLLs at most phase 3's
   ``restarts=1`` sum plus 1e-3 of it), the sparse joint fit with
   ``restarts=2`` at full width (depth cut to p = 8), and the dense model
   with ``restarts=2`` at the largest bucket whose memory, reckoned from
   what phase 4's graphed step pins, stays under 24 GiB; batched launches
   of both kernels, host reads, escalations, peak and pinned memory.
9. ``fused="batched"`` (``[batched]`` lines, :func:`phase_batched_fit`):
   the dense ``replace=False`` model on fully observed data, p = 16, all
   layers as one batch, against the graphed scan fit at the largest bucket
   whose reckoned peak stays under 24 GiB (layer NLLs within 1e-5 at the
   initial latents; after 10 iterations the gap is printed), and JAX's
   error for each broken precondition.
10. Greedy ordering (``[greedy]`` lines, :func:`phase_greedy`):
   ``fit(greedy=True, iters=10)`` of the bench's model with
   ``compat=False`` on the bench's data with its columns shuffled by a
   fixed permutation, graphed, cold and warm (the same order and bits, the
   ``10k`` gates in the original columns), and the dense model at
   n = 2000; the search's and the fit's wall-clocks, host reads and rounds
   of trials per position, and the scorer's batched launches (every scorer
   Gram one batched launch; no plain-route Gram, no ``gram_eval``).
11. The examples' configurations (``[configs]`` lines,
   :func:`phase_configs`) at n = 2000, p = 4, sparse and dense, in
   float32 on the card (finite, the analyser's terms, no ``gram_eval``),
   and at n = 96 in float64 against the CPU (rtol 1e-6).
12. The serving layer (``[serve]`` lines, :func:`phase_serve`): the
   posterior-factor cache at full width, cached against uncached (the
   same bits, 2p Grams fewer per sparse call and p per dense call): the
   ``[main]`` model's and the ``[ancestral]`` model's predicts and the
   posterior score of the 2000-row dataset, the dense model at n = 2000,
   and the dense bench model, whose stack is over the limit (nothing
   cached); ``warmup`` and the first request after it (no capture, the
   ``10k`` gates); a checkpoint's save and load (the same bits); CUDA
   tensors that require grad as inputs; and the graph cache under a
   one-step byte budget (one step kept, reserved memory printed).
13. The unrolled oracle (``[unroll]`` lines, :func:`phase_unroll`):
   ``fit(fused="unroll")`` of the bench's sparse model at full width, cold
   and warm from phase 3's initial latents (the same bits; wall-clock,
   host reads, launches; the sum of layer NLLs beside the graphed scan
   fit's), and ``predict`` / posterior ``sample`` with
   ``config.scan_predict = False`` from the scan-fitted latents and the
   normals the scan tail drew (max |d| of the draws and the mean; the
   ``10k`` gates); the dense model at n = 2000 the same way; and float64 at
   n = 2000, p = 4, sparse and dense: the unrolled fit, predict, sample and
   posterior score against the scan routes, 1e-8 relative.  Every run
   through the kernels (no plain-route Gram, no ``gram_eval``).
14. The examples' own workloads (``[examples]`` lines,
   :func:`phase_examples`): eeg, exchange, jura and air_temp at sizes 0
   and 2 on the synthetic stand-ins of ``gpar_torch.utils.data`` at the
   data's sizes, each with its script's constructor arguments, in float64:
   at the ``--quick`` counts the script's ``check_metric`` gate (a
   ``SystemExit`` fails the run), at the full counts timed, the metric
   printed.
15. The device mesh (``[mesh]`` lines, :func:`phase_mesh`) on a virtual
   mesh of the card four times over: the bench's sparse request under
   ``mesh=`` (graphed, cold and warm: the ``10k`` gates, the same bits,
   the sum of layer NLLs within 1e-3 relative of phase 3's, host reads and
   launch checks; the split predictive and both scores against one
   device), the dense model at n = 2000 through the distributed Cholesky,
   and float64 at n = 2000, p = 4 against one device (1e-8).
16. The traced and profiled fit (``[trace]`` lines, :func:`phase_trace`):
   ``fit_predict(..., trace=True)`` of the bench's sparse request at full
   width and depth (optax's zoom-line-search L-BFGS in the per-layer
   driver; one ``lbfgs iter`` line per iteration, each finite; the ``10k``
   gates), the dense model at n = 2000 traced, float64 at n = 2000, p = 4
   traced on the card against the CPU (1e-8 relative), and
   ``fit(profile_dir=)`` of a traced and of a cold graphed fit, whose
   ``*.pt.trace.json`` must hold device events of both Gram kernels.
17. Small-input agreement: a float64 fit_predict (p=3, n=100, sparse with
   8 inducing points and dense, ``replace`` True and False) through the
   scan path on the card (graphed) against the same run on the CPU (eager;
   the CPU route is held against the JAX package by the test suite), rtol
   1e-6; then ``fit(fix=False)`` and the prior and posterior scores of
   other data after it, sparse and dense, the same way; then three restarts
   of the graphed scan against the per-layer driver's sequential restarts,
   and ``fused="batched"`` (one start and two) against the graphed scan,
   all on the card, from the same normals (rtol 1e-6); and the greedy
   search at n = 64, p = 4, sparse and dense, on the card against the CPU
   (the same order, NLLs to rtol 1e-6).
18. Summary: ``[main]``, ``[dense]``, ``[ancestral]``, ``[logpdf]``,
   ``[free]``, ``[restarts]``, ``[batched]``, ``[greedy]``, ``[configs]``,
   ``[serve]``, ``[unroll]``, ``[examples]``, ``[mesh]`` and ``[trace]`` JSON lines, a ``kernels``
   JSON line (launches of the sparse and the dense graphed cold runs, the
   scan-route scores' cold runs and the sparse joint fit; the sample-axis
   route's from the ``[ancestral]`` sparse cold and dense requests and the
   ``[examples]`` runs; the per-element-parameter forward and the batched
   backward from the ``[restarts]``, ``[batched]`` and ``[greedy]`` runs;
   the ``[serve]`` phase's first cached calls and its request after
   warmup; the ``[unroll]`` phase's cold fits and predicts; the
   ``[examples]`` phase's ``--quick`` runs; the ``[mesh]`` phase's sparse
   cold and dense mesh requests, ``launches_by_path["mesh"]``, with the
   per-shard shapes' rows; the ``[trace]`` phase's sparse request and
   dense fit), the card line, and last
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` additionally traces one warm (graphed) fit_predict of each
path with ``torch.profiler``, writes the per-kernel tables to ``DIR``,
prints the device time by kind of kernel and holds the Gram kernels' launch
counters against the profiler's count of their kernels.  ``--kernels-only`` runs
phases 1 and 2 alone, for iterating on the kernels, and prints no result
line.
"""

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("GPAR_TORCH_NO_X64", "1")  # float32, as the benchmark

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
H100_FP64_FLOPS = 34e12  # float64 outside the tensor cores

# The benchmark's golden quality gates (bench.py QUALITY_GATES["10k"]).
GATES = dict(mean_smse=5e-4, worst_smse=2e-3, nll_decrease=5e4)

#: The scan path's Grams on the main path: Kmn and Kmm of the fit (rows
#: bucketed 10 000 -> 11 840), Kmt and the test covariance of the predict
#: tail (test rows 1024 -> 1216).
SCAN_SHAPES = [(256, 11_840), (256, 256), (256, 1216), (1216, 1216)]
#: The per-shard Grams of the ``[mesh]`` phase's 4-shard virtual mesh: the
#: sparse fit's Kmn of one shard (11 840 rows / 4) and the dense fit's rows
#: of one shard at n = 2000 (bucket 2432, padded to 4 x 768 = 3072 rows).
MESH_SHAPES = [(256, 2960), (768, 3072)]
#: The dense path's (no inducing points) Grams beyond those: K of the fit
#: and the tail, and the tail's test cross-covariance (the test covariance is
#: SCAN_SHAPES[3]).  Their plain versions are run in row blocks.
DENSE_SHAPES = [(11_840, 11_840), (11_840, 1216)]
#: The Grams of a scored dataset of 2000 rows (bucket 2432), forward only
#: (the scores run under no_grad): the sparse prior's Kmn, the dense
#: posterior's cross-covariance against the training rows and the dense K.
SCORE_SHAPES = [(256, 2432), (11_840, 2432), (2432, 2432)]
#: Rows per block of a plain version at a dense shape: the plain Gram builds
#: an (n, m, d) difference tensor, 9.5 GB per term at 11 840^2 in float32.
PLAIN_ROWS = 1024


def make_data(n=10_000, p=16, seed=0):
    """The benchmark's synthetic closed-downwards chain (``bench.py``):
    returns ``(x, y, f)`` with ``f`` the noiseless truth."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, size=n))
    cols = [np.sin(x) - x**2 / 50.0]
    for i in range(1, p):
        prev = cols[-1]
        cols.append(np.cos(prev) ** 2 + np.sin((i + 1) * x / 3.0) / (1 + i / 8.0))
    f = np.stack(cols, axis=1)
    y = f + 0.05 * rng.standard_normal((n, p))
    return x.astype(np.float32), y.astype(np.float32), f.astype(np.float32)


def model_kwargs(x, n_ind=256):
    """The benchmark's model (``bench.py`` build_model): air-temp style
    D-GPAR-L-NL with inducing points over the data range."""
    return dict(
        scale=0.2,
        linear=True,
        linear_scale=10.0,
        nonlinear=True,
        nonlinear_scale=1.0,
        noise=0.1,
        impute=True,
        replace=True,
        normalise_y=True,
        x_ind=np.linspace(float(x.min()), float(x.max()), n_ind),
    )


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, reps):
    """Device time per call: the summed durations of the CUDA kernels that
    ``reps`` calls of ``fn`` ran, from ``torch.profiler`` — unlike CUDA
    events around back-to-back launches, it excludes the gaps in which the
    card waits for the host.  The profiler now and then records no device
    events for a window; it is tried three times, then CUDA events around
    the ``reps`` calls stand in (gaps included, so an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time for e in prof.events() if e.device_type == cuda)
        if total_us > 0:
            return total_us / reps / 1e3
    print("[kernel] torch.profiler recorded no device time three times; timing with CUDA events")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gram_bound_ms(kinds, dims, n, m, itemsize, batch=1, shared=""):
    """Least time of one Gram on an H100: the larger of the bytes it must
    move (features read once, Gram written once) over the memory rate and
    its operations over the non-tensor-core rate of the dtype.  The function
    needs 2 operations per feature and output for every kind of term (a
    product and a sum; the norm identity reduces a squared distance to one
    inner product), whatever form the kernel chose.  ``batch`` Grams of one
    call with a sample axis read a ``shared`` ("left" or "right") operand
    once."""
    D = sum(dims)
    rows = (n if shared == "left" else batch * n) + (m if shared == "right" else batch * m)
    bytes_ = itemsize * (batch * n * m + rows * D + 2 * len(kinds) + 1)
    per_elem = 2 * D + 4 * len(kinds) + 1  # tail per term (w*, exp, +) and the constant
    flops = batch * n * m * per_elem
    peak = H100_FP32_FLOPS if itemsize == 4 else H100_FP64_FLOPS
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


#: Operations of the Gram backward per output element and feature of a term,
#: and per output element for the term's tail, by kind.  rbf / rq: s, then
#: P v and P^T u, each a product and a sum per feature under the norm
#: identity; lin: G v and G^T u only (dw = sum_ik u_ik (G v)_ik reuses G v,
#: 2 n d more).  Tails: rbf exp, G e, its sum, P; rq h, log1p, exp,
#: G r^(-a), its sum, the dalpha summand (3) and its sum, P; lin P = w G.
BWD_OPS = {"rbf": (6, 4), "rq": (6, 10), "lin": (4, 1)}


def gram_bwd_bound_ms(kinds, dims, n, m, itemsize):
    """Least time of one Gram backward on an H100, the same way: bytes are
    the upstream gradient G read once, the features read once and their
    gradients written once, ``itemsize * (n m + 2 (n + m) sum d)``;
    operations are ``BWD_OPS`` per kind, 1 per output for the constant's
    sum, and a lin term's ``2 n d`` for dw."""
    D = sum(dims)
    bytes_ = itemsize * (n * m + 2 * (n + m) * D + 2 * (2 * len(kinds) + 1))
    per_elem = 1 + sum(BWD_OPS[k][0] * d + BWD_OPS[k][1] for k, d in zip(kinds, dims))
    flops = n * m * per_elem + sum(2 * n * d for k, d in zip(kinds, dims) if k == "lin")
    peak = H100_FP32_FLOPS if itemsize == 4 else H100_FP64_FLOPS
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def layer_tree(pi, dtype, device, seed=1):
    """Layer ``pi``'s kernel as the estimator builds it for the benchmark's
    model, at seeded hyperparameters near their initial values."""
    import torch

    from gpar_torch.models.regressor import _model_generator, GPARRegressor
    from gpar_torch.params.store import Vars, load_latents

    cfg = GPARRegressor(**model_kwargs(np.zeros(2)), device=device, dtype=dtype).model_config
    vs = Vars(dtype=dtype, device=device)
    gen = _model_generator(vs, 1, pi, **cfg)
    gen()
    r = np.random.default_rng(seed + pi)
    snap = vs.snapshot()
    load_latents(vs, {k: v + 0.2 * r.standard_normal(v.shape) for k, v in snap.items()})
    return gen()[0].kernel


def gated_tree(dtype, device, m=1, P1=16, pi=9):
    """A gated layer kernel built like the scan step's ``_layer_kernel``
    (``gpar_torch/models/fused.py``): width ``m + P1`` (17 on the main
    path), inputs gated to the first ``m`` columns, outputs to the ``pi``
    modelled ones."""
    import torch

    from gpar_torch.ops.kernels import EQ, Linear

    def P(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    out_gate = (np.arange(P1) < pi).astype(float)
    r = np.random.default_rng(3)
    k = (P(1.3) * EQ().stretch(P(np.r_[[0.2] * m, np.ones(P1)]))).gate(P(np.r_[np.ones(m), np.zeros(P1)]))
    gate_out = P(np.r_[np.zeros(m), out_gate])
    k = k + Linear().stretch(P(np.r_[np.ones(m), r.uniform(5, 15, P1)])).gate(gate_out)
    k = k + P(0.8) * EQ().stretch(P(np.r_[np.ones(m), r.uniform(0.5, 2, P1)])).gate(gate_out)
    return k


def wide_tree(dtype, device):
    """A tree wider than the kernels' staging chunks (64 features in float32,
    32 in float64): rbf and lin terms of 120 features each and an rq term of
    24, 264 features in all; its width needs the backward's opt-in to more
    than 48 KB of shared memory."""
    import torch

    from gpar_torch.ops.kernels import EQ, RQ, Linear

    def P(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    k = P(1.1) * EQ().stretch(P(np.linspace(6.0, 10.0, 120)))
    k = k + Linear().stretch(P(np.linspace(8.0, 12.0, 120)))
    return k + RQ(P(0.8)).stretch(P(np.linspace(2.0, 4.0, 24))).select(list(range(24)))


def edge_tree(dtype, device):
    """Terms at the edges of the backward's lane maps, on 64 input columns:
    rbf 2, rq 15, lin 17, rq 33 and rbf 64 features, which reach every tail
    of the du sum's feature groups (8, 4 or 2 at a time by tile, then 4, 2
    and 1) and, past 24 features, its chunks."""
    import torch

    from gpar_torch.ops.kernels import EQ, RQ, Linear

    def P(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def first(d):
        return list(range(d))

    k = EQ().stretch(P([0.9, 1.4])).select(first(2))
    k = k + RQ(P(0.7)).stretch(P(np.linspace(2.0, 4.0, 15))).select(first(15))
    k = k + P(0.6) * Linear().stretch(P(np.linspace(6.0, 9.0, 17))).select(first(17))
    k = k + RQ(P(1.3)).stretch(P(np.linspace(3.0, 6.0, 33))).select(first(33))
    return k + P(1.2) * EQ().stretch(P(np.linspace(6.0, 10.0, 64)))


def inputs(n, d, dtype, device, seed):
    import torch

    r = np.random.default_rng(seed)
    a = np.concatenate([r.uniform(0, 10, (n, 1)), r.standard_normal((n, d - 1))], axis=1)
    return torch.as_tensor(a, dtype=dtype, device=device)


def rel_err(got, want):
    """max |got - want| / max |want| over a tuple of tensors, each scaled by
    its own largest entry, and the largest absolute error."""
    import torch

    rel = ab = 0.0
    for a, b in zip(got, want):
        err = float(torch.max(torch.abs(a - b)))
        rel = max(rel, err / max(float(torch.max(torch.abs(b))), 1e-30))
        ab = max(ab, err)
    return rel, ab


def plain_by_rows(GK, prep, g=None, dtype=None):
    """The plain Gram (``g`` None) or its VJP for ``g`` on ``PLAIN_ROWS``-row
    blocks of u against all of v, in ``dtype`` (default: the inputs'):
    the Gram's blocks stacked, or dxf's blocks stacked with dyf and dpar
    summed over the blocks.  In float64 the order of those sums does not
    matter at the tolerances held."""
    import torch

    kinds, dims, xf, yf, par = prep
    dtype = xf.dtype if dtype is None else dtype
    xf, yf, par = (a.to(dtype) for a in (xf, yf, par))
    blocks = range(0, xf.shape[0], PLAIN_ROWS)
    if g is None:
        return torch.cat([GK.gram_terms_plain(kinds, dims, xf[i:i + PLAIN_ROWS], yf, par) for i in blocks])
    dx, dy, dp = [], 0, 0
    for i in blocks:
        a, b, c = GK.gram_terms_plain_vjp(kinds, dims, xf[i:i + PLAIN_ROWS], yf, par,
                                          g[i:i + PLAIN_ROWS].to(dtype))
        dx.append(a)
        dy, dp = dy + b, dp + c
    return torch.cat(dx), dy, dp


def bwd_plan_text(GK, n, m, n_terms, dtype, device, batch=1):
    """The backward's grid at one shape, as the wrapper plans it."""
    import torch

    ct, r, rps, step = GK._bwd_plan(n, m, n_terms, dtype, device, batch)
    blocks = ct * r * n_terms * batch
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    elems = f" x {batch} elements" if batch > 1 else ""
    return (f"plan {ct} column tiles x {r} row splits of {rps} rows (steps of {step}) x {n_terms} "
            f"terms{elems} = {blocks} blocks, {blocks / sms:.2f} per SM (busiest {-(-blocks // sms)})")


def phase_kernel_check(device):
    import torch

    from gpar_torch.ops import gram_kernel as GK
    from gpar_torch.ops.kernels import gram_eval

    shapes = [(256, 256), (256, 10_000), (256, 1024), (1024, 1024)]
    rows = {"gram": [], "gram_bwd": []}
    worst = {"gram": {torch.float32: 0.0, torch.float64: 0.0},
             "gram_bwd": {torch.float32: 0.0, torch.float64: 0.0}}
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    bwd_tol = {torch.float32: 1e-4, torch.float64: 1e-10}
    for dtype in (torch.float32, torch.float64):
        cases = [("bench-pi0", layer_tree(0, dtype, device), 1)]
        cases.append(("bench-pi15", layer_tree(15, dtype, device), 16))
        cases.append(("gated", gated_tree(dtype, device), 17))
        cases.append(("wide", wide_tree(dtype, device), 120))
        cases.append(("edges", edge_tree(dtype, device), 64))
        only = {"gated": SCAN_SHAPES + DENSE_SHAPES + MESH_SHAPES, "wide": [(37, 23), (256, 1024)],
                "edges": [(37, 23), (300, 133), SCAN_SHAPES[0]]}
        for name, tree, d in cases:
            for n, m in only.get(name, shapes + [(37, 23)]):
                x = inputs(n, d, dtype, device, seed=n + d)
                y = inputs(m, d, dtype, device, seed=m + 7 * d)
                with torch.no_grad():
                    prep = GK.prepare_terms(tree, x, y)
                dense = (n, m) in DENSE_SHAPES
                got = GK.gram_kernel_launch(*prep)
                torch.cuda.synchronize()
                if dense:  # in float64 row blocks, against the kernel's output upcast
                    want = plain_by_rows(GK, prep, dtype=torch.float64)
                    got = got.to(torch.float64)
                else:
                    want = GK.gram_terms_plain(*prep)
                torch.cuda.synchronize()
                err = float(torch.max(torch.abs(got - want)))
                scale = float(torch.max(torch.abs(want)))
                ok = bool(torch.allclose(got, want, rtol=tol[dtype], atol=tol[dtype]))
                print(f"[kernel] {name} {str(dtype)[6:]} ({n}, {m}) d={d}: "
                      f"max|err| {err:.3e} (max|K| {scale:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"gram kernel disagrees with its plain version: {name} {dtype} {(n, m)}")
                worst["gram"][dtype] = max(worst["gram"][dtype], err)

                g = torch.randn(n, m, dtype=dtype, device=device,
                                generator=torch.Generator(device).manual_seed(n + m))
                bgot = GK.gram_bwd_kernel_launch(*prep, g)
                torch.cuda.synchronize()
                if dense:
                    bwant = plain_by_rows(GK, prep, g, dtype=torch.float64)
                    bgot = tuple(a.to(torch.float64) for a in bgot)
                else:
                    bwant = GK.gram_terms_plain_vjp(*prep, g)
                torch.cuda.synchronize()
                brel, babs = rel_err(bgot, bwant)
                bok = brel <= bwd_tol[dtype]
                print(f"[kernel] backward {name} {str(dtype)[6:]} ({n}, {m}) d={d}: "
                      f"max|err|/max|plain| {brel:.3e} (max|err| {babs:.3e}) {'ok' if bok else 'FAIL'}")
                if not bok:
                    raise AssertionError(f"gram backward kernel disagrees with its plain version: "
                                         f"{name} {dtype} {(n, m)}")
                worst["gram_bwd"][dtype] = max(worst["gram_bwd"][dtype], babs)
                del want, bwant
                if (n, m) in (SCAN_SHAPES[0], DENSE_SHAPES[0]):
                    # No atomics: a second launch gives the same bits.
                    again = GK.gram_bwd_kernel_launch(*prep, g)
                    torch.cuda.synchronize()
                    bits = all(torch.equal(a.to(b.dtype), b) for a, b in zip(bgot, again))
                    print(f"[kernel] backward {name} {str(dtype)[6:]} ({n}, {m}): "
                          f"{bwd_plan_text(GK, n, m, len(prep[0]), dtype, x.device)}; two launches "
                          f"give the same bits: {bits}")
                    if not bits:
                        raise AssertionError(f"two backward launches differ: {name} {dtype} {(n, m)}")

                if dtype == torch.float32 and name not in ("wide", "edges") and (n, m) != (37, 23):
                    kinds, dims = prep[0], prep[1]
                    # At a dense shape the plain version is timed as it is
                    # checked, in row blocks (in float32).
                    for kname, fk, fp, bound, e in (
                        ("gram", lambda: GK.gram_kernel_launch(*prep),
                         (lambda: plain_by_rows(GK, prep)) if dense else (lambda: GK.gram_terms_plain(*prep)),
                         gram_bound_ms, err),
                        ("gram_bwd", lambda: GK.gram_bwd_kernel_launch(*prep, g),
                         (lambda: plain_by_rows(GK, prep, g)) if dense
                         else (lambda: GK.gram_terms_plain_vjp(*prep, g)), gram_bwd_bound_ms, babs),
                    ):
                        k_ms = device_ms(fk, 20 if dense else 50)
                        p_ms = device_ms(fp, 2 if dense else 10)
                        b_ms, b_by = bound(kinds, dims, n, m, 4)
                        rows[kname].append(dict(tree=name, n=n, m=m, d=d, ms=k_ms, plain_ms=p_ms,
                                                bound_ms=b_ms, bound_by=b_by, max_abs_err=e))
                        print(f"[kernel] time {kname} {name} ({n}, {m}) f32: kernel {k_ms:.5f} ms device, "
                              f"plain {p_ms:.5f} ms device, bound {b_ms:.6f} ms ({b_by})")
                    print(f"[kernel] backward plan {name} ({n}, {m}) f32: "
                          f"{bwd_plan_text(GK, n, m, len(kinds), dtype, x.device)}")

    # The scored data's Grams, forward only, against the plain version in
    # float64 row blocks (the kernel's output upcast), timed in float32.
    for dtype in (torch.float32, torch.float64):
        tree = gated_tree(dtype, device)
        for n, m in SCORE_SHAPES:
            x = inputs(n, 17, dtype, device, seed=n + 5)
            y = inputs(m, 17, dtype, device, seed=m + 9)
            with torch.no_grad():
                prep = GK.prepare_terms(tree, x, y)
            got = GK.gram_kernel_launch(*prep).to(torch.float64)
            want = plain_by_rows(GK, prep, dtype=torch.float64)
            torch.cuda.synchronize()
            err = float(torch.max(torch.abs(got - want)))
            ok = bool(torch.allclose(got, want, rtol=tol[dtype], atol=tol[dtype]))
            print(f"[kernel] score gated {str(dtype)[6:]} ({n}, {m}) d=17: max|err| {err:.3e} "
                  f"(max|K| {float(torch.max(torch.abs(want))):.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"gram kernel disagrees with its plain version: score {dtype} {(n, m)}")
            worst["gram"][dtype] = max(worst["gram"][dtype], err)
            del got, want
            if dtype == torch.float32:
                k_ms = device_ms(lambda: GK.gram_kernel_launch(*prep), 20)
                p_ms = device_ms(lambda: plain_by_rows(GK, prep), 2)
                b_ms, b_by = gram_bound_ms(prep[0], prep[1], n, m, 4)
                rows["gram"].append(dict(tree="gated-score", n=n, m=m, d=17, ms=k_ms, plain_ms=p_ms,
                                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
                print(f"[kernel] time gram score ({n}, {m}) f32: kernel {k_ms:.5f} ms device, plain "
                      f"{p_ms:.5f} ms device, bound {b_ms:.6f} ms ({b_by})")

    # Gradient of the fused Gram (both kernels, through the feature maps)
    # against autograd through the plain recursion.  The recursion forms
    # squared distances by the norm identity, which in float32 loses
    # ~eps |u|^2 to cancellation; so the float32 gradient is held against the
    # recursion run in float64 on the same inputs, tree and R, upcast, and
    # its distance from the float32 recursion is only printed.
    def grads(fn, tree, x, y, R):
        tree, leaves = GK.map_leaves(tree, lambda l: l.detach().clone().requires_grad_(True))
        x, y = (a.detach().clone().requires_grad_(True) for a in (x, y))
        return torch.autograd.grad(torch.sum(fn(tree, x, y) * R), [x, y, *leaves])

    def up(a):
        return a.to(torch.float64)

    for dtype, limit in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        tree = layer_tree(15, dtype, device)
        x = inputs(256, 16, dtype, device, seed=11)
        y = inputs(1024, 16, dtype, device, seed=12)
        R = torch.randn(256, 1024, dtype=dtype, device=device, generator=torch.Generator(device).manual_seed(0))
        got = grads(GK.gram_fused_or_none, tree, x, y, R)
        same = grads(gram_eval, tree, x, y, R)
        ref = grads(gram_eval, GK.map_leaves(tree, up)[0], up(x), up(y), up(R))
        torch.cuda.synchronize()
        rel, _ = rel_err([up(g) for g in got], ref)
        rel_same, _ = rel_err(got, same)
        print(f"[kernel] gradient {str(dtype)[6:]}: max|err|/max|ref| {rel:.3e} against the float64 "
              f"recursion over {len(got)} tensors {'ok' if rel <= limit else 'FAIL'} (limit {limit:g}); "
              f"{rel_same:.3e} against the {str(dtype)[6:]} recursion")
        if rel > limit:
            raise AssertionError(f"fused Gram gradient disagrees ({dtype})")

    # The free fit's Grams: one tensor on both sides, K = gram(k, x_aug,
    # x_aug), whose output columns were written out of place from a tensor
    # that requires a gradient (the earlier layers' estimates), so the
    # gradient reaches the inputs through both operands; at Kmm's shape and
    # at the scored dense K's.
    def aug_grads(fn, tree, base, cols, R):
        tree, leaves = GK.map_leaves(tree, lambda l: l.detach().clone().requires_grad_(True))
        base, cols = (a.detach().clone().requires_grad_(True) for a in (base, cols))
        idx = torch.arange(1, 1 + cols.shape[1], device=base.device)
        xa = torch.cat([base, base.new_zeros(base.shape[0], cols.shape[1])], dim=1).index_copy(1, idx, cols)
        return torch.autograd.grad(torch.sum(fn(tree, xa, xa) * R), [base, cols, *leaves])

    # float32: the backward kernel's own tolerance (its sums over 2432 rows
    # and columns run in another order than the recursion's).
    for dtype, limit in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        for n in (256, 2432):
            tree = gated_tree(dtype, device)
            a = inputs(n, 17, dtype, device, seed=n + 21)
            base, cols = a[:, :1].contiguous(), a[:, 1:].contiguous()
            R = torch.randn(n, n, dtype=dtype, device=device, generator=torch.Generator(device).manual_seed(1))
            got = aug_grads(GK.gram_fused_or_none, tree, base, cols, R)
            ref = aug_grads(gram_eval, GK.map_leaves(tree, up)[0], up(base), up(cols), up(R))
            torch.cuda.synchronize()
            rel, _ = rel_err([up(g) for g in got], ref)
            print(f"[kernel] gradient through both operands, inputs requiring a gradient, {str(dtype)[6:]} "
                  f"({n}, {n}): max|err|/max|ref| {rel:.3e} against the float64 recursion over {len(got)} "
                  f"tensors {'ok' if rel <= limit else 'FAIL'} (limit {limit:g})")
            if rel > limit:
                raise AssertionError(f"fused Gram input gradient disagrees ({dtype}, {n})")
    return rows, worst


#: The per-sample tails' Grams with a sample axis, (S, n, m) and the operand
#: every sample shares, at the benchmark's shapes, each at S = 90, the first
#: chunk of 100 samples at 1216 test rows under the "auto" rule: Kmt (the
#: inducing inputs shared), the test covariances (both operands the samples'
#: test inputs), and the dense tail's cross-covariance (the training rows
#: shared; its plain version runs in row blocks in float64).
BATCHED_SHAPES = [(90, 256, 1216, "left"), (90, 1216, 1216, ""), (90, 11_840, 1216, "left")]


def batched_plain(GK, prep, s, dtype=None):
    """The plain version of sample ``s`` of a Gram with a sample axis,
    through ``plain_by_rows``."""
    kinds, dims, xf, yf, par = prep
    return plain_by_rows(GK, (kinds, dims, xf[s] if xf.ndim == 3 else xf,
                              yf[s] if yf.ndim == 3 else yf, par), dtype=dtype)


def phase_batched_kernel_check(device):
    """The Gram kernel with a sample axis (one launch for S Grams) against
    its plain version in both dtypes at ``BATCHED_SHAPES`` (rtol/atol 1e-5
    in float32, 1e-12 in float64), and in float32 its device time beside S
    separate 2-D launches of the same Grams, the plain version's and the
    bound."""
    import torch

    from gpar_torch.ops import gram_kernel as GK

    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rows, worst = [], {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        tree = gated_tree(dtype, device)
        for S, n, m, shared in BATCHED_SHAPES:
            xb = torch.stack([inputs(m, 17, dtype, device, seed=1000 + s) for s in range(S)])
            left = inputs(n, 17, dtype, device, seed=n + 17) if shared == "left" else xb
            with torch.no_grad():
                prep = GK.prepare_terms(tree, left, xb)
            before = GK.gram_batched_kernel_launches
            got = GK.gram_kernel_launch(*prep)
            torch.cuda.synchronize()
            if GK.gram_batched_kernel_launches != before + 1 or tuple(got.shape) != (S, n, m):
                raise AssertionError(f"batched Gram: shape {tuple(got.shape)}, "
                                     f"{GK.gram_batched_kernel_launches - before} batched launches")
            dense = n > 1216
            err = kmax = 0.0
            ok = True
            for s in range(S):  # every sample, each against its own plain Gram
                want = batched_plain(GK, prep, s, dtype=torch.float64 if dense else None)
                g = got[s].to(want.dtype)
                err = max(err, float(torch.max(torch.abs(g - want))))
                kmax = max(kmax, float(torch.max(torch.abs(want))))
                ok = ok and bool(torch.allclose(g, want, rtol=tol[dtype], atol=tol[dtype]))
                del want, g
            what = f"({S}, {n}, {m}) {'left operand shared' if shared else 'both operands batched'}"
            print(f"[kernel] batched gated {str(dtype)[6:]} {what}: one launch, all {S} samples against "
                  f"the plain version, max|err| {err:.3e} (max|K| {kmax:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"batched gram kernel disagrees with its plain version: {dtype} {what}")
            worst[dtype] = max(worst[dtype], err)
            del got
            if dtype != torch.float32:
                continue
            kinds, dims, xf, yf, par = prep

            def separate():
                for s in range(S):
                    GK.gram_kernel_launch(kinds, dims, xf if xf.ndim == 2 else xf[s], yf[s], par)

            k_ms = device_ms(lambda: GK.gram_kernel_launch(*prep), 10 if dense else 20)
            sep_ms = device_ms(separate, 2 if dense else 5)
            p_ms = device_ms(lambda: torch.stack([batched_plain(GK, prep, s) for s in range(S)]), 1)
            b_ms, b_by = gram_bound_ms(kinds, dims, n, m, 4, batch=S, shared=shared)
            rows.append(dict(tree="gated", S=S, n=n, m=m, d=17, shared=shared or "none", ms=k_ms,
                             separate_ms=sep_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=err))
            print(f"[kernel] time batched gram {what} f32: kernel {k_ms:.5f} ms device, {S} separate "
                  f"2-D launches {sep_ms:.5f} ms, plain {p_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by})")
    return rows, worst


#: Batches of per-element trees: restarts (R = 4) of the sparse fit at Kmn
#: and Kmm, and all 16 layers times 4 starts of a dense fused="batched" fit
#: of a 2000-row dataset (bucket 2432).  Features and parameters carry the
#: batch (each element's length scales give it its own features).
PARAM_BATCH_SHAPES = [(4, 256, 11_840), (4, 256, 256), (64, 2432, 2432)]
#: The greedy scorer's Grams at its first position: all 16 candidates of the
#: bench's model as one batch, Kmn of the sparse model (and with the left
#: operand shared by the batch) and K of the dense one at a 2000-row
#: dataset (bucket 2432); every candidate's tree is the estimator's layer-0
#: tree with its own parameters.
SCORER_SHAPES = [(16, 256, 11_840, ""), (16, 256, 11_840, "left"), (16, 2432, 2432, "")]


def gated_tree_batched(B, dtype, device, m=1, P1=16, pi=9, seed=5):
    """:func:`gated_tree` with every hyperparameter carrying a leading batch
    axis of ``B`` elements (the trees of a batch of restarts), each element's
    drawn around the tree's own values."""
    import torch

    from gpar_torch.ops.kernels import EQ, Linear

    r = np.random.default_rng(seed)

    def P(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def jitter(v, k=None):
        shape = (B,) if k is None else (B, k)
        return P(np.asarray(v) * np.exp(0.3 * r.standard_normal(shape)))

    out_gate = (np.arange(P1) < pi).astype(float)
    gate_in = P(np.r_[np.ones(m), np.zeros(P1)])
    gate_out = P(np.r_[np.zeros(m), out_gate])
    k = (jitter(1.3) * EQ().stretch(jitter(np.r_[[0.2] * m, np.ones(P1)], m + P1))).gate(gate_in)
    k = k + Linear().stretch(jitter(np.r_[np.ones(m), r.uniform(5, 15, P1)], m + P1)).gate(gate_out)
    k = k + jitter(0.8) * EQ().stretch(jitter(np.r_[np.ones(m), r.uniform(0.5, 2, P1)], m + P1)).gate(gate_out)
    return k


def scorer_tree_batched(C, position, dtype, device, seed=7):
    """The greedy scorer's tree at ``position`` for the bench's model, as
    ``GPARRegressor._greedy_position_nlls`` builds it: the estimator's layer
    tree (``_model_generator``) whose leaves carry a candidate axis of ``C``,
    each candidate's latents drawn around the fresh initialisation.  Returns
    ``(tree, input width)``."""
    import torch

    from gpar_torch.models.regressor import GPARRegressor, _model_generator
    from gpar_torch.params.store import Vars

    cfg = GPARRegressor(**model_kwargs(np.zeros(2)), device=device, dtype=dtype).model_config
    vs = Vars(dtype=dtype, device=device)
    _model_generator(vs, 1, position, **cfg)()
    names = vs.select(None)
    z0 = vs.latent_vector(names)
    noise = np.random.default_rng(seed).standard_normal((C, z0.numel()))
    z = z0 + 0.3 * torch.as_tensor(noise, dtype=dtype, device=device)
    f, _ = _model_generator(vs.with_latent_vector(names, z), 1, position, **cfg)()
    return f.kernel, 1 + position


def element(prep, b):
    """Element ``b`` of prepared terms with a batch axis (a shared operand as
    it is)."""
    kinds, dims, xf, yf, par = prep
    return (kinds, dims, xf[b] if xf.ndim == 3 else xf, yf[b] if yf.ndim == 3 else yf,
            par[b] if par.ndim == 2 else par)


def phase_param_batched_kernel_check(device):
    """Both kernels over a batch of per-element trees, the route of the
    restarts, of ``fused="batched"`` and of the greedy scorer: one launch
    of the forward kernel for B Grams with per-element parameters (the JAX
    package's vmapped ``pallas_call``), one of the backward kernel for
    their VJP, at ``PARAM_BATCH_SHAPES`` and ``SCORER_SHAPES``, in both
    dtypes, every element against its plain version in float64 (forward 1e-5 / 1e-12, backward max|err|/max|plain|
    1e-4 / 1e-10), two launches of each giving the same bits; at Kmn also
    with the left operand shared by the batch, whose gradient is the sum
    over it.  In float32 the device time of each beside B separate 2-D
    launches, the plain version's (element by element) and B times the
    single Gram's bound."""
    import torch

    from gpar_torch.ops import gram_kernel as GK

    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    bwd_tol = {torch.float32: 1e-4, torch.float64: 1e-10}
    rows = {"gram": [], "gram_bwd": []}
    worst = {k: {torch.float32: 0.0, torch.float64: 0.0} for k in rows}
    cases = ([(B, n, m, "", "gated") for B, n, m in PARAM_BATCH_SHAPES]
             + [(*PARAM_BATCH_SHAPES[0], "left", "gated")]
             + [(*shape, "scorer") for shape in SCORER_SHAPES])
    for dtype in (torch.float32, torch.float64):
        for B, n, m, shared, kind in cases:
            if kind == "gated":
                tree, d = gated_tree_batched(B, dtype, device), 17
            else:
                tree, d = scorer_tree_batched(B, 0, dtype, device)
            x = inputs(n, d, dtype, device, seed=n + 3)
            y = inputs(m, d, dtype, device, seed=m + 4)
            with torch.no_grad():
                prep = GK.prepare_terms(tree, x, y)
            if shared:  # the left features shared by every element
                prep = (*prep[:2], prep[2][0].contiguous(), *prep[3:])
            kinds, dims = prep[:2]
            what = (f"({B}, {n}, {m}) per-element parameters"
                    + (", left operand shared" if shared else "")
                    + (", the greedy scorer's position-0 tree" if kind == "scorer" else ""))
            dt = str(dtype)[6:]
            before = (GK.gram_batched_kernel_launches, GK.gram_bwd_batched_kernel_launches)
            got = GK.gram_kernel_launch(*prep)
            g = torch.randn(B, n, m, dtype=dtype, device=device,
                            generator=torch.Generator(device).manual_seed(B + n))
            bgot = GK.gram_bwd_kernel_launch(*prep, g)
            again = (GK.gram_kernel_launch(*prep), GK.gram_bwd_kernel_launch(*prep, g))
            torch.cuda.synchronize()
            counted = (GK.gram_batched_kernel_launches - before[0],
                       GK.gram_bwd_batched_kernel_launches - before[1])
            if counted != (2, 2) or tuple(got.shape) != (B, n, m):
                raise AssertionError(f"batched kernels {what}: shape {tuple(got.shape)}, batched "
                                     f"launches counted {counted}")
            bits = torch.equal(got, again[0]) and all(torch.equal(a, b) for a, b in zip(bgot, again[1]))
            del again
            err = kmax = 0.0
            ok = True
            bgrads = [torch.zeros_like(a, dtype=torch.float64) for a in bgot]
            for b in range(B):
                el = element(prep, b)
                want = plain_by_rows(GK, el, dtype=torch.float64)
                gb = got[b].to(torch.float64)
                err = max(err, float(torch.max(torch.abs(gb - want))))
                kmax = max(kmax, float(torch.max(torch.abs(want))))
                ok = ok and bool(torch.allclose(gb, want, rtol=tol[dtype], atol=tol[dtype]))
                del want, gb
                for i, (a, w) in enumerate(zip(bgot, plain_by_rows(GK, el, g[b], dtype=torch.float64))):
                    if a.ndim == w.ndim:  # a shared operand: the sum over the batch
                        bgrads[i] += w
                    else:
                        bgrads[i][b] = w
            brel, babs = rel_err([a.to(torch.float64) for a in bgot], bgrads)
            bok = brel <= bwd_tol[dtype]
            torch.cuda.synchronize()
            print(f"[kernel] param-batched {kind} {dt} {what}: forward max|err| {err:.3e} (max|K| "
                  f"{kmax:.3e}) {'ok' if ok else 'FAIL'}; backward max|err|/max|plain| {brel:.3e} (max|err| "
                  f"{babs:.3e}) {'ok' if bok else 'FAIL'}; two launches of each give the same bits: {bits}; "
                  f"backward {bwd_plan_text(GK, n, m, len(kinds), dtype, x.device, B)}")
            if not (ok and bok and bits):
                raise AssertionError(f"param-batched kernels disagree with their plain versions or are not "
                                     f"deterministic: {dtype} {what}")
            worst["gram"][dtype] = max(worst["gram"][dtype], err)
            worst["gram_bwd"][dtype] = max(worst["gram_bwd"][dtype], babs)
            del bgrads
            if dtype != torch.float32:
                continue

            def separate(bwd):
                for b in range(B):
                    el = element(prep, b)
                    if bwd:
                        GK.gram_bwd_kernel_launch(*el, g[b])
                    else:
                        GK.gram_kernel_launch(*el)

            def plain(bwd):
                for b in range(B):
                    el = element(prep, b)
                    if bwd:
                        plain_by_rows(GK, el, g[b])
                    else:
                        plain_by_rows(GK, el)

            for kname, bwd, bound, e in (("gram", False, gram_bound_ms, err),
                                         ("gram_bwd", True, gram_bwd_bound_ms, babs)):
                launch = (lambda: GK.gram_bwd_kernel_launch(*prep, g)) if bwd else (lambda: GK.gram_kernel_launch(*prep))
                reps = 5 if n * m > 10**6 else 20
                k_ms = device_ms(launch, reps)
                sep_ms = device_ms(lambda: separate(bwd), max(1, reps // 4))
                p_ms = device_ms(lambda: plain(bwd), 1)
                one_ms, b_by = bound(kinds, dims, n, m, 4)
                rows[kname].append(dict(tree=f"{kind}-batched", B=B, n=n, m=m, d=d, shared=shared or "none",
                                        ms=k_ms, separate_ms=sep_ms, plain_ms=p_ms, bound_ms=B * one_ms,
                                        bound_by=b_by, max_abs_err=e))
                print(f"[kernel] time param-batched {kname} {what} f32: kernel {k_ms:.5f} ms device, {B} "
                      f"separate 2-D launches {sep_ms:.5f} ms, plain {p_ms:.5f} ms, {B} x the single bound "
                      f"{B * one_ms:.6f} ms ({b_by})")
            del got, bgot, g
    return rows, worst


def operator_table(prof, top=10):
    """Device time by operator (the kernels of nested operators counted in
    their parents' too), the ``top`` largest, as ``{name: [ms, calls]}``."""
    ops = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.cpu_time_total > 0 and e.device_time_total > 0), key=lambda t: -t[1])[:top]
    return {k: [ms, c] for k, ms, c in ops}


def phase_ancestral(device, replace_true_reg):
    """Per-sample ancestral sampling at full width (``[ancestral]`` lines):
    the benchmark's request with ``replace=False`` (the constructor's
    default), sparse, cold and warm against the ``10k`` gates, then
    ``latent=True``; ``sample(posterior=True)`` of it and of the ``[main]``
    phase's ``replace=True`` model, and a prior ``sample`` with p = 16, each
    of 100 samples at the 1024 test inputs; the dense model (``x_ind=None``)
    once (its tail, as every tail, computes each layer's factors in its
    loop, so no 16 x 11 840 x 11 858 x 4 B stack is held).  Every run: fit
    and predict wall-clock, peak device memory and the launch counters, set
    to 0 just before it and read just after: forward launches, batched ones
    among them (> 0), no plain-route Gram and no ``gram_eval`` on the card,
    and for a fit backward launches equal to the Grams under autograd.  Then one profiled ``predict`` of each model:
    device time by operator, the batched Cholesky's share among them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.models import graphs
    from gpar_torch.ops import gram_kernel as GK

    P = "[ancestral]"
    gpar_torch.config.epsilon = 1e-6
    n, p, n_test, num_samples, iters = 10_000, 16, 1024, 100, 10
    x, y, f = make_data(n, p)
    test_idx = np.arange(n)[:: n // n_test][:n_test]
    x_test, f_test = x[test_idx], f[test_idx]
    res = {}

    def run(tag, fn, fit, batched=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        GK.reset_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = GK.counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{P} {tag}: {wall:.3f} s; peak device memory {peak:.2f} GiB; gram kernel launches "
              f"{c['gram_kernel_launches']} ({c['gram_batched_kernel_launches']} with a sample axis), "
              f"backward launches {c['gram_bwd_kernel_launches']} for {c['gram_autograd_calls']} Grams "
              f"under autograd, plain-route CUDA Grams {c['gram_plain_cuda_calls']}, gram_eval on CUDA "
              f"{c['gram_eval_cuda_calls']}")
        if (c["gram_kernel_launches"] <= 0 or (c["gram_batched_kernel_launches"] <= 0) == batched
                or c["gram_plain_cuda_calls"] or c["gram_eval_cuda_calls"]):
            raise AssertionError(f"{tag}: the run bypassed the kernel: {c}")
        if fit and not 0 < c["gram_bwd_kernel_launches"] == c["gram_autograd_calls"]:
            raise AssertionError(f"{tag}: backward launches do not match the Grams under autograd: {c}")
        res[tag] = dict(wall_s=wall, peak_gib=peak, launches=c["gram_kernel_launches"],
                        batched_launches=c["gram_batched_kernel_launches"],
                        gram_eval_calls=c["gram_eval_cuda_calls"])
        return out

    def request(reg, tag, gates=True, **kw):
        """One request from the model's initial latents."""
        reg.condition(x, y)
        reg._ensure_vars(reg.p)
        reg.vs.restore(z_init[reg.sparse])
        gen = torch.Generator(device).manual_seed(0)
        out = run(tag, lambda: reg.fit_predict(x, y, x_test, iters=iters, num_samples=num_samples,
                                               credible_bounds=True, generator=gen, **kw), fit=True)
        rep = reg.last_fit_report
        res[tag].update(fit_s=rep["wall_clock_s"], predict_s=res[tag]["wall_s"] - rep["wall_clock_s"],
                        **check_quality(P, tag, out, rep, f_test, gates=gates))
        print(f"{P} {tag}: fit {rep['wall_clock_s']:.3f} s, predict {res[tag]['predict_s']:.3f} s")
        return out

    def samples(reg, tag, batched=True, **kw):
        gen = torch.Generator(device).manual_seed(1)
        out = run(tag, lambda: reg.sample(x_test, num_samples=num_samples, generator=gen, **kw), fit=False,
                  batched=batched)
        if len(out) != num_samples or not all(a.shape == (n_test, p) and np.isfinite(a).all() for a in out):
            raise AssertionError(f"{tag}: misshapen or non-finite samples")

    def profiled(reg, tag):
        gen = torch.Generator(device).manual_seed(0)
        reg.predict(x_test, num_samples=num_samples, credible_bounds=True, generator=gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reg.predict(x_test, num_samples=num_samples, credible_bounds=True, generator=gen)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        cuda = torch.autograd.DeviceType.CUDA
        busy = sum(e.device_time for e in prof.events() if e.device_type == cuda) / 1e3
        ops = operator_table(prof)
        chol = ops.get("aten::linalg_cholesky_ex", [0.0, 0])
        res[f"profile {tag}"] = dict(wall_ms=wall, device_ms=busy, ops=ops)
        print(f"{P} profiled predict, {tag}: wall {wall:.1f} ms, device {busy:.1f} ms (busy "
              f"{100 * busy / wall:.1f}%); batched Cholesky (aten::linalg_cholesky_ex) {chol[0]:.1f} ms "
              f"over {chol[1]} calls ({100 * chol[0] / max(busy, 1e-9):.1f}% of the device time); by operator: "
              + ", ".join(f"{k} {ms:.1f} ms ({c})" for k, (ms, c) in ops.items()))

    kw = dict(model_kwargs(x), replace=False)
    reg = GPARRegressor(**kw, device=device)
    dense = GPARRegressor(**dict(kw, x_ind=None), device=device)
    z_init = {}
    for r in (reg, dense):
        r.condition(x, y)
        r._ensure_vars(r.p)
        z_init[r.sparse] = r.vs.snapshot()
    cold = request(reg, "sparse cold")
    warm = request(reg, "sparse warm")
    same = all(np.array_equal(a, b) for a, b in zip(cold, warm))
    print(f"{P} sparse cold and warm predictions identical: {same}")
    request(reg, "sparse latent", gates=False, latent=True)
    samples(reg, "sample posterior replace=False", posterior=True)
    # replace=True: every sample shares each layer's covariance, no sample axis.
    samples(replace_true_reg, "sample posterior replace=True", batched=False, posterior=True)
    samples(reg, f"sample prior p={p}", p=p)
    profiled(reg, "sparse")

    graphs.clear_cache()  # the sparse steps' pools; the dense step pins its own
    request(dense, "dense", gates=False)
    profiled(dense, "dense")
    graphs.clear_cache()
    res["sparse_cold_warm_identical"] = same
    return res, reg


def check_quality(P, tag, out, rep, f_test, gates=True):
    """Finite predictions of the expected shape with the mean inside its
    bounds, the sum of layer NLLs before and after the fit and the SMSE of
    the mean against the noiseless truth; with ``gates`` held to the
    benchmark's ``10k`` quality gates."""
    from gpar_torch.utils.metrics import smse

    mean, lo, hi = out
    for a in out:
        assert a.shape == f_test.shape and np.isfinite(a).all(), f"{tag}: non-finite or misshapen predictions"
    assert np.all(lo <= mean + 1e-6) and np.all(mean <= hi + 1e-6), f"{tag}: mean outside its bounds"
    nll0, nll = float(np.sum(rep["layer_nll0"])), float(np.sum(rep["layer_nll"]))
    sm = smse(mean, f_test)
    q = dict(nll0=nll0, nll=nll, nll_decrease=nll0 - nll, mean_smse=float(np.nanmean(sm)),
             worst_smse=float(np.nanmax(sm)))
    print(f"{P} {tag}: sum NLL {nll0:.1f} -> {nll:.1f} (decrease {nll0 - nll:.1f}); SMSE vs "
          f"noiseless truth mean {q['mean_smse']:.3e}, worst {q['worst_smse']:.3e}; L-BFGS "
          f"iterations per layer {rep['layer_iters'].tolist()}")
    if not gates:
        return q
    if q["nll_decrease"] < GATES["nll_decrease"]:
        raise AssertionError(f"{tag}: NLL decrease {q['nll_decrease']:.1f} below {GATES['nll_decrease']}")
    if q["mean_smse"] > GATES["mean_smse"] or q["worst_smse"] > GATES["worst_smse"]:
        raise AssertionError(f"{tag}: SMSE mean {q['mean_smse']:.3e} / worst {q['worst_smse']:.3e} "
                             "above the gates")
    return q


def phase_main_path(device, dense=False):
    """The benchmark's request at full width through every route: graphed
    cold and warm, the eager step and the per-layer driver; ``dense`` drops
    the inducing points (``x_ind=None``: the exact marginal likelihood over
    the (11 840, 11 840) bucketed rows).  Lines are tagged ``[main]`` or
    ``[dense]``."""
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.ops import gram_kernel as GK

    from gpar_torch.config import bucket_rows

    P = "[dense]" if dense else "[main]"
    gpar_torch.config.epsilon = 1e-6  # float32 jitter floor, as bench.py
    n, p, n_test, num_samples, iters = 10_000, 16, 1024, 100, 10
    x, y, f = make_data(n, p)
    test_idx = np.arange(n)[:: n // n_test][:n_test]
    x_test, f_test = x[test_idx], f[test_idx]

    kw = model_kwargs(x)
    if dense:
        kw["x_ind"] = None
    reg = GPARRegressor(**kw, device=device)
    assert reg.dtype == torch.float32 and reg.sparse == (not dense)
    reg.condition(x, y)
    reg._ensure_vars(reg.p)
    z_init = reg.vs.snapshot()

    def run(**kw):
        """One request from the same initial latents; the Gram counters are
        set to 0 just before it and read just after."""
        reg.vs.restore(z_init)
        gen = torch.Generator(device).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        GK.reset_counters()
        t0 = time.perf_counter()
        out = reg.fit_predict(x, y, x_test, iters=iters, num_samples=num_samples,
                              credible_bounds=True, generator=gen, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = dict(reg.last_fit_report, peak_bytes=torch.cuda.max_memory_allocated())
        return out, wall, rep, GK.counters()

    def quality(tag, out, rep):
        return check_quality(P, tag, out, rep, f_test)

    def same(a, b):
        return (np.array_equal(a[2]["layer_nll"], b[2]["layer_nll"])
                and all(np.array_equal(u, v) for u, v in zip(a[0], b[0])))

    def check_counts(tag, counts):
        """Every Gram of the run through the forward kernel, every Gram
        under autograd through the backward kernel, none elsewhere."""
        if counts["gram_kernel_launches"] <= 0 or counts["gram_plain_cuda_calls"] or counts["gram_eval_cuda_calls"]:
            raise AssertionError(f"{tag}: main path bypassed the kernel: {counts}")
        if not 0 < counts["gram_bwd_kernel_launches"] == counts["gram_autograd_calls"]:
            raise AssertionError(f"{tag}: backward launches do not match the Grams under autograd: {counts}")

    def timing(tag, wall, rep):
        return (f"{P} {tag}: fit_predict {wall:.3f} s (fit {rep['wall_clock_s']:.3f} s, predict "
                f"{wall - rep['wall_clock_s']:.3f} s); peak device memory "
                f"{rep['peak_bytes'] / 2**30:.2f} GiB")

    before = reserved_bytes()
    cold = run()
    pinned = reserved_bytes() - before
    warm = run()
    res = {}
    for tag, (out, wall, rep, counts) in (("graphed cold", cold), ("graphed warm", warm)):
        res[tag] = quality(tag, out, rep)
        bound = (int(np.sum(rep["layer_iters"])) + rep["linesearch_trials"] + rep["linesearch_episodes"]
                 + 1)
        print(timing(tag, wall, rep) + f"; capture {rep['capture_s']:.3f} s; graph replays "
              f"{rep['graph_replays']}; host reads {rep['host_syncs']} (bound {bound}: L-BFGS iterations "
              f"{int(np.sum(rep['layer_iters']))} + backtracking trials {rep['linesearch_trials']} + "
              f"episodes {rep['linesearch_episodes']} + 1 for the results); factorisations past the "
              f"first jitter rung {rep['ladder_escalations']}")
        print(f"{P} {tag}: gram kernel launches {counts['gram_kernel_launches']}, backward kernel "
              f"launches {counts['gram_bwd_kernel_launches']} for {counts['gram_autograd_calls']} Grams "
              f"under autograd, plain-route CUDA Grams {counts['gram_plain_cuda_calls']}, gram_eval on "
              f"CUDA {counts['gram_eval_cuda_calls']} (replays included)")
        if not rep["fused"] or rep["graph_replays"] <= 0:
            raise AssertionError(f"{tag}: the fit did not replay the scan step's graphs: {rep}")
        check_counts(tag, counts)
        if rep["host_syncs"] > bound:
            raise AssertionError(f"{tag}: {rep['host_syncs']} host reads, more than {bound}")
    print(f"{P} the cached graphed step (its buffers and its graphs' memory pools) pins "
          f"{pinned / 2**30:.2f} GiB of device memory")
    identical = same(cold, warm)
    print(f"{P} cold and warm runs identical (layer NLLs and predictions): {identical}")
    if not identical:
        raise AssertionError("cold and warm runs differ: the main path is not deterministic")

    fixed = dict(cold=cold, warm=warm, state=(reg, x, y, x_test, z_init))
    if dense:
        # The eager step and the per-layer driver at n = 4000 (bucket 4800),
        # not 11 840 rows, to keep the script inside its time limit
        # (PERF.md §4).  The 10k gates are for 10 000 rows (at 4000 the
        # graphed fit's mean SMSE is 5.5e-4, PERF.md §6, PR 13), so the
        # eager step is held to a graphed run's bits at that size and the
        # driver to its sum of layer NLLs within 1e-3 relative.
        x, y, f = make_data(4000, p)
        test_idx = np.arange(4000)[:: 4000 // n_test][:n_test]
        x_test, f_test = x[test_idx], f[test_idx]
        reg = GPARRegressor(**kw, device=device)
        reg.condition(x, y)
        reg._ensure_vars(reg.p)
        z_init = reg.vs.snapshot()
        warm = run()
        print(timing("graphed at n = 4000", warm[1], warm[2]))

        def quality(tag, out, rep):
            q = check_quality(P, tag, out, rep, f_test, gates=False)
            if q["nll_decrease"] <= 0:
                raise AssertionError(f"{tag} at n = 4000: the fit did not lower the NLL: {q}")
            return q

        res["graphed n=4000"] = quality("graphed at n = 4000", warm[0], warm[2])
    eager = run(cuda_graphs=False)
    res["eager"] = quality("eager step", eager[0], eager[2])
    d_nll = float(np.max(np.abs(eager[2]["layer_nll"] - warm[2]["layer_nll"])))
    d_pred = max(float(np.max(np.abs(a - b))) for a, b in zip(eager[0], warm[0]))
    eq = same(eager, warm)
    print(timing("eager step on the card", eager[1], eager[2]) + f"; host reads {eager[2]['host_syncs']}; "
          f"identical to the graphed run: {eq} (max |d layer NLL| {d_nll:.3e}, max |d prediction| "
          f"{d_pred:.3e})")
    if not eq:
        raise AssertionError("the graphed scan step and the eager scan step differ on the card")

    check_counts("eager step", eager[3])
    if eager[2]["graph_replays"]:
        raise AssertionError(f"eager step: {eager[2]['graph_replays']} graph replays")

    driver = run(fused=False)
    res["driver"] = quality("per-layer driver", driver[0], driver[2])
    dc = driver[3]
    scan_q = res["graphed n=4000" if dense else "graphed warm"]
    if dense and abs(res["driver"]["nll"] - scan_q["nll"]) > 1e-3 * abs(scan_q["nll"]):
        raise AssertionError(f"the per-layer driver's sum of layer NLLs {res['driver']['nll']} is not within "
                             f"1e-3 of the graphed scan's {scan_q['nll']} at n = 4000")
    print(timing("per-layer driver (fused=False)", driver[1], driver[2]) + f"; sum of layer NLLs "
          f"{res['driver']['nll']:.1f} against the scan path's {scan_q['nll']:.1f}; gram "
          f"kernel launches {dc['gram_kernel_launches']}, backward kernel launches "
          f"{dc['gram_bwd_kernel_launches']} for {dc['gram_autograd_calls']} Grams under autograd, "
          f"plain-route CUDA Grams {dc['gram_plain_cuda_calls']}, gram_eval on CUDA "
          f"{dc['gram_eval_cuda_calls']}")
    if driver[2]["fused"]:
        raise AssertionError("fused=False did not run the per-layer driver")
    check_counts("per-layer driver", dc)

    cold, warm = fixed["cold"], fixed["warm"]
    rep, counts = cold[2], cold[3]
    return dict(
        launches=counts["gram_kernel_launches"], bwd_launches=counts["gram_bwd_kernel_launches"],
        autograd_grams=counts["gram_autograd_calls"], plain_calls=counts["gram_plain_cuda_calls"],
        gram_eval_calls=counts["gram_eval_cuda_calls"], cold_s=cold[1], warm_s=warm[1],
        cold_fit_s=rep["wall_clock_s"], warm_fit_s=warm[2]["wall_clock_s"], capture_s=rep["capture_s"],
        graph_replays=warm[2]["graph_replays"], host_syncs=warm[2]["host_syncs"],
        ladder_escalations=warm[2]["ladder_escalations"], linesearch_trials=warm[2]["linesearch_trials"],
        linesearch_episodes=warm[2]["linesearch_episodes"],
        layer_iters=int(np.sum(warm[2]["layer_iters"])), eager_s=eager[1], driver_s=driver[1],
        eager_rows=bucket_rows(len(x)),  # the bucket of the eager step's and the driver's rows
        driver_fit_s=driver[2]["wall_clock_s"], peak_gib_cold=cold[2]["peak_bytes"] / 2**30,
        peak_gib_warm=warm[2]["peak_bytes"] / 2**30, peak_gib_eager=eager[2]["peak_bytes"] / 2**30,
        peak_gib_driver=driver[2]["peak_bytes"] / 2**30, pinned_gib=pinned / 2**30,
        **{f"{k}_{q}": v for k, qs in (("scan", res["graphed warm"]), ("driver", res["driver"]))
           for q, v in qs.items()},
    ), fixed["state"]


def phase_dense_evaluation(reg, device):
    """One evaluation (value and gradient) of the dense layer objective at
    the fitted latents, layer 0, at the bucketed (rows, rows) shape,
    eagerly under ``torch.profiler``: the Cholesky factorisations it runs
    (``aten::linalg_cholesky_ex``, cuSOLVER ``potrf``) and their device time,
    with the scan step's on-device ladder (every rung probed, then the
    chosen one factored again) against the host ladder of the per-layer
    driver (``ops.linalg.safe_cholesky``: the rungs it needs), on the same
    matrix."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpar_torch.models.fused import ScanStep, _cusolver, _layer_nll_factors
    from gpar_torch.ops.linalg import HOST

    names = reg.vs.select(None)
    plan = reg._scan_fit_plan(names)
    x_pad, rows = reg._bucket_fit_inputs(plan)
    n_b = x_pad.shape[0]
    step = ScanStep(plan, n_b, 0, reg.dtype, device)
    step.load(reg.vs.latent_vector(names), x_pad, rows, x_pad.new_zeros((0, plan.m)))
    out = {}
    with _cusolver(device):
        step.layer_init()  # layer 0's plan slice, and a first evaluation
        z = step.z_ext.index_select(0, step.lin["layer_gather"])

        def evaluation(jitter):
            zz = z.detach().requires_grad_(True)
            with torch.enable_grad():
                nll = _layer_nll_factors(plan, step.lin, step._full(zz), step.x_aug, step.zi_aug,
                                         jitter)[0]
                torch.autograd.grad(nll, zz)

        for ladder, jitter in (("on-device ladder (scan step)", step.finish),
                               ("host ladder (per-layer driver)", HOST)):
            evaluation(jitter)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                evaluation(jitter)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            cuda = torch.autograd.DeviceType.CUDA
            total = sum(e.device_time for e in prof.events() if e.device_type == cuda) / 1e3
            chol = [e for e in prof.key_averages() if e.key == "aten::linalg_cholesky_ex"]
            calls = chol[0].count if chol else 0
            chol_ms = chol[0].device_time_total / 1e3 if chol else 0.0
            # Device time by operator, kernels of nested operators included
            # in their parents' (the Cholesky backward holds a matmul and
            # two triangular solves).
            ops = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                          if e.cpu_time_total > 0 and e.device_time_total > 0), key=lambda t: -t[1])[:8]
            out[ladder] = dict(cholesky_calls=calls, cholesky_ms=chol_ms, device_ms=total, wall_ms=1e3 * wall,
                               ops={k: [ms, c] for k, ms, c in ops})
            print(f"[dense] one evaluation (value and gradient, layer 0, {n_b} x {n_b}, {str(reg.dtype)[6:]}), "
                  f"{ladder}: {calls} Cholesky factorisations (cuSOLVER potrf) taking {chol_ms:.2f} ms of "
                  f"{total:.2f} ms device time; wall {1e3 * wall:.2f} ms; by operator: "
                  + ", ".join(f"{k} {ms:.2f} ms ({c})" for k, ms, c in ops))
    return out


#: Largest relative gap of a float32 score from the float64 score of the
#: same data and latents on the card, where the float32 chain rounds the
#: float64 one: the sparse prior under either ``compat`` and the sparse
#: posterior under ``compat=False`` (measured 4.1e-3 to 8.0e-3, PR 8).
SCORE_GAP_F32 = 2e-2
#: The scores whose float32 value is not a rounding of the float64 one,
#: keyed by (model, posterior, compat): the gap is printed, not held.
UNHELD_GAP = {
    ("sparse", True, True): "the posterior covariances K - T1'T1 + T2'T2 cancel in float32, and compat=True "
                            "scores un-normalised outputs, whose large residuals amplify that",
    **{("dense", post, compat): "the float32 jitter ladder may take a later rung on an (n, n) factor than the "
                                "float64 one: another regulariser, not a rounding"
       for post in (False, True) for compat in (False, True)},
}
#: The scan route against the GP-core route, float64, relative.
ROUTE_TOL_F64 = 1e-9
#: A chain NLL against minus the score of the same chain, float32: the
#: rounding of a sum of 16 layer NLLs.
IDENTITY_TOL_F32 = 1e-5


def launches_checked(tag, fn, backward):
    """``fn()`` with the Gram counters set to 0 just before it and read just
    after, its wall-clock and peak device memory: every Gram through the
    forward kernel (no plain-route Gram, no ``gram_eval`` on the card), and
    backward launches equal to the Grams under autograd, which ``backward``
    says are there or not.  Returns ``(out, wall_s, peak_gib, counters)``."""
    import torch

    from gpar_torch.ops import gram_kernel as GK

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    GK.reset_counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = GK.counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if c["gram_kernel_launches"] <= 0 or c["gram_plain_cuda_calls"] or c["gram_eval_cuda_calls"]:
        raise AssertionError(f"{tag}: the run bypassed the kernel: {c}")
    if c["gram_bwd_kernel_launches"] != c["gram_autograd_calls"] or (c["gram_bwd_kernel_launches"] > 0) != backward:
        raise AssertionError(f"{tag}: backward launches do not match the Grams under autograd: {c}")
    return out, wall, peak, c


def phase_logpdf(device, sparse_reg, dense_reg):
    """The bench's serving score at full width (``[logpdf]`` lines;
    ``bench.py:205-211``): a fresh dataset ``make_data(2000, 16, seed=500)``
    scored under the prior and the posterior of the sparse and the dense
    bench models that the main phases fitted, twice each (cold, warm),
    through the scan routes: time, Gram launches (counted from 0 for each
    call), peak memory; the two calls agree exactly; the float64 scan
    route (a float64 estimator given the fitted latents) agrees with the
    GP-core route to ``ROUTE_TOL_F64``; under either ``compat`` each score's
    gap from the float64 score of the same data on the card is printed and
    held to ``SCORE_GAP_F32`` where float32 rounds the float64 chain, and
    ``UNHELD_GAP`` says why it does not elsewhere.  Then
    ``sample_missing`` on the scored data with 10 % of the entries of
    outputs 0..14 missing and the normals given (sparse prior and
    posterior, dense prior): finite, two calls equal.  Then the training
    identity: a ``compat=False`` model fitted with ``fix=True`` scores its
    training data at ``-sum(layer_nll)`` to ``IDENTITY_TOL_F32``."""
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.models.gpar import per_output

    P = "[logpdf]"
    gpar_torch.config.epsilon = 1e-6
    n, p, n_score = 10_000, 16, 2000
    x, y, _ = make_data(n, p)
    xs, ys, _ = make_data(n_score, p, seed=500)
    res = {"launches": 0}

    rng = np.random.default_rng(501)
    ym = ys.copy()
    ym[:, :15][rng.uniform(size=ym[:, :15].shape) < 0.1] = np.nan
    # One vector of normals per layer that draws: the layers before the last
    # with missing rows under the closed-downwards routing that keeps them.
    counts = [int(np.isnan(yi).sum()) for i, (yi, _, _) in enumerate(per_output(ym, np.ones_like(ym), keep=True))
              if i < p - 1 and np.isnan(yi).any()]
    normals = [rng.standard_normal(c) for c in counts]

    for name, reg in (("sparse", sparse_reg), ("dense", dense_reg)):
        kw = dict(model_kwargs(x), x_ind=None if name == "dense" else model_kwargs(x)["x_ind"])
        reg64 = GPARRegressor(**kw, device=device, dtype=torch.float64)
        reg64.condition(x.astype(np.float64), y.astype(np.float64))
        reg64.load_latents(reg.vs.snapshot())
        for posterior in (False, True):
            kind = "posterior" if posterior else "prior"
            scores = []
            for run in ("cold", "warm"):
                tag = f"{name} {kind} {run}"
                score, wall, peak, c = launches_checked(
                    tag, lambda: reg.logpdf(xs, ys, posterior=posterior), backward=False)
                scores.append(score)
                res[tag] = dict(score=score, wall_s=wall, peak_gib=peak, launches=c["gram_kernel_launches"])
                if run == "cold":
                    res["launches"] += c["gram_kernel_launches"]
                print(f"{P} {tag}: score {score!r}, {wall:.3f} s, gram kernel launches "
                      f"{c['gram_kernel_launches']}, peak device memory {peak:.2f} GiB")
            if not (np.isfinite(scores[0]) and scores[0] == scores[1]):
                raise AssertionError(f"{name} {kind}: cold and warm scores differ or are not finite: {scores}")
            s64 = reg64.logpdf(xs, ys, posterior=posterior)
            core = reg64._logpdf_core(*reg64._score_data(xs, ys, None, posterior), posterior)
            route = abs(core - s64) / abs(s64)
            res[f"{name} {kind}"] = dict(float64=s64, core_float64=core, route_gap=route)
            print(f"{P} {name} {kind}: cold == warm {scores[0] == scores[1]}; float64 score {s64!r}; float64 "
                  f"GP-core route {core!r}, scan-to-core gap {route:.3e} (limit {ROUTE_TOL_F64:g})")
            if route > ROUTE_TOL_F64:
                raise AssertionError(f"{name} {kind}: scan-to-core gap {route:.3e}")
            for compat in (True, False):
                reg.compat = reg64.compat = compat
                s32 = reg.logpdf(xs, ys, posterior=posterior)
                s64c = reg64.logpdf(xs, ys, posterior=posterior)
                gap = abs(s32 - s64c) / abs(s64c)
                why = UNHELD_GAP.get((name, posterior, compat))
                res[f"{name} {kind}"][f"compat={compat}"] = dict(float32=s32, float64=s64c, gap_f32=gap,
                                                                 held=why is None)
                print(f"{P} {name} {kind} compat={compat}: float32 {s32!r}, float64 {s64c!r}, gap {gap:.3e} "
                      + (f"(limit {SCORE_GAP_F32:g})" if why is None else f"(not held: {why})"))
                if why is None and gap > SCORE_GAP_F32:
                    raise AssertionError(f"{name} {kind} compat={compat}: float32 gap {gap:.3e}")
            reg.compat = reg64.compat = True
        if name == "dense":
            noise = {k: float(v) for k, v in reg.get_variables().items() if k.endswith("/noise")}
            low = {k: v for k, v in noise.items() if v < 1e-6}
            res["dense noise below the float32 floor"] = low
            print(f"{P} dense: fitted noise variances below the float32 floor of 1e-6: {low}")
        del reg64

        for posterior in ((False, True) if name == "sparse" else (False,)):
            kind = "posterior" if posterior else "prior"
            tag = f"{name} {kind} sample_missing"
            runs = [launches_checked(tag, lambda: reg.logpdf(xs, ym, posterior=posterior, sample_missing=True,
                                                             normals=normals), backward=False)
                    for _ in range(2)]
            a, b = runs[0][0], runs[1][0]
            res[tag] = dict(score=a, wall_s=runs[0][1], draws=counts)
            print(f"{P} {tag} ({len(counts)} drawing layers, {sum(counts)} draws): score {a!r}, "
                  f"{runs[0][1]:.3f} s; two calls with the same normals equal: {a == b}")
            if not (np.isfinite(a) and a == b):
                raise AssertionError(f"{tag}: {a!r} and {b!r}")

    # The training identity at the fit's own bucket (11 840 rows).
    ident = GPARRegressor(**model_kwargs(x), compat=False, device=device)
    ident.fit(x, y, iters=10)
    want = -float(np.sum(ident.last_fit_report["layer_nll"].astype(np.float64)))
    got = ident.logpdf(x, y)
    rel = abs(got - want) / abs(want)
    res["identity"] = dict(score=got, minus_sum_layer_nll=want, rel=rel)
    print(f"{P} training identity (sparse, compat=False, fix=True graphed fit): logpdf(x, y) {got!r}, "
          f"-sum(layer_nll) {want!r}, relative gap {rel:.3e} (limit {IDENTITY_TOL_F32:g})")
    if rel > IDENTITY_TOL_F32:
        raise AssertionError(f"training identity: {got!r} against {want!r}")
    return res


def phase_free(device):
    """The joint fit ``fit(fix=False)`` (``[free]`` lines): the sparse bench
    model at full width (n = 10 000, p = 16, ``compat=False``), 10 L-BFGS
    iterations per position, then ``predict`` (``replace=True``, 100
    samples) against the ``10k`` SMSE gates; the last position's NLL equals
    ``-logpdf(x, y)`` (the last position's objective is the whole chain);
    wall-clock, iterations per position, host reads, peak memory and launch
    counts.  The dense model runs the same at a reduced size, n = 2000,
    p = 4 (a dense evaluation at 11 840 rows takes about 0.28 s, and the
    free fit runs about 8.5 times the fixed fit's layer evaluations)."""
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.utils.metrics import smse

    P = "[free]"
    gpar_torch.config.epsilon = 1e-6
    res = {}
    for name, n, p, iters in (("sparse", 10_000, 16, 10), ("dense", 2000, 4, 10)):
        x, y, f = make_data(n, p)
        n_test = 1024 if name == "sparse" else 200
        test_idx = np.arange(len(x))[:: max(1, len(x) // n_test)][:n_test]
        kw = model_kwargs(x)
        if name == "dense":
            kw["x_ind"] = None
        reg = GPARRegressor(**kw, compat=False, device=device)
        _, fit_s, peak, c = launches_checked(f"{name} fit(fix=False)",
                                             lambda: reg.fit(x, y, fix=False, iters=iters), backward=True)
        rep = reg.last_fit_report
        gen = torch.Generator(device).manual_seed(0)
        mean, wall_p, _, _ = launches_checked(
            f"{name} predict", lambda: reg.predict(x[test_idx], num_samples=100, generator=gen), backward=False)
        sm = smse(mean, f[test_idx])
        score = reg.logpdf(x, y)
        last = float(rep["layer_nll"][-1])
        rel = abs(last + score) / abs(score)
        q = dict(n=n, p=p, iters=iters, fit_s=fit_s, report_fit_s=rep["wall_clock_s"], predict_s=wall_p,
                 peak_gib=peak, layer_iters=rep["layer_iters"].tolist(), host_syncs=rep["host_syncs"],
                 linesearch_trials=rep["linesearch_trials"], ladder_escalations=rep["ladder_escalations"],
                 launches=c["gram_kernel_launches"], bwd_launches=c["gram_bwd_kernel_launches"],
                 autograd_grams=c["gram_autograd_calls"], layer_nll_last=last, logpdf=score,
                 identity_rel=rel, mean_smse=float(np.nanmean(sm)), worst_smse=float(np.nanmax(sm)))
        res[name] = q
        size = "full width" if name == "sparse" else f"reduced size n = {n}, p = {p}"
        print(f"{P} {name} ({size}): fit(fix=False, iters={iters}) {fit_s:.3f} s, predict {wall_p:.3f} s; "
              f"peak device memory {peak:.2f} GiB; L-BFGS iterations per position {q['layer_iters']}; "
              f"host reads {q['host_syncs']} (backtracking trials {q['linesearch_trials']}); factorisations "
              f"past the first jitter rung {q['ladder_escalations']}; gram kernel launches {q['launches']}, "
              f"backward launches {q['bwd_launches']} for {q['autograd_grams']} Grams under autograd")
        print(f"{P} {name}: SMSE vs noiseless truth mean {q['mean_smse']:.3e}, worst {q['worst_smse']:.3e}; "
              f"last position's chain NLL {last!r} against -logpdf(x, y) {-score!r}, relative gap {rel:.3e} "
              f"(limit {IDENTITY_TOL_F32:g})")
        if not np.isfinite(mean).all() or rel > IDENTITY_TOL_F32:
            raise AssertionError(f"{name} free fit: non-finite predictions or identity gap {rel:.3e}")
        if name == "sparse" and (q["mean_smse"] > GATES["mean_smse"] or q["worst_smse"] > GATES["worst_smse"]):
            raise AssertionError(f"free fit: SMSE mean {q['mean_smse']:.3e} / worst {q['worst_smse']:.3e} "
                                 "above the gates")
    return res


#: The least device memory a phase's reckoned peak may take; the largest
#: bucket under it is run.
RECKON_LIMIT_GIB = 24.0
#: Outputs of the multi-start joint fit (the bench's 16 cut to 8).
JOINT_RESTART_DEPTH = 8


def reserved_bytes():
    """Memory the allocator holds once its unused cache is released: the
    live tensors and the captured graphs' pools."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def largest_bucket(per_bucket_gib):
    """``(n_b, reckoned GiB)``: the largest row bucket up to 11 840 whose
    reckoned peak ``per_bucket_gib(n_b)`` stays under ``RECKON_LIMIT_GIB``."""
    from gpar_torch.config import bucket_rows

    buckets, n = [], 64
    while not buckets or buckets[-1] < 11_840:
        buckets.append(bucket_rows(n))
        n = buckets[-1] + 1
    fits = [b for b in buckets if per_bucket_gib(b) < RECKON_LIMIT_GIB]
    return fits[-1], per_bucket_gib(fits[-1])


def rows_for_bucket(n_b):
    """A row count whose bucket is ``n_b`` (its bucket's 0.85)."""
    from gpar_torch.config import bucket_rows

    n = int(0.85 * n_b)
    assert bucket_rows(n) == n_b, (n, n_b)
    return n


def check_batched_counts(tag, c):
    """A multi-start or batched fit: batched launches of both kernels, every
    Gram through the forward kernel, none through a plain route or
    ``gram_eval``, backward launches equal to the Grams under autograd."""
    if (c["gram_batched_kernel_launches"] <= 0 or c["gram_bwd_batched_kernel_launches"] <= 0
            or c["gram_plain_cuda_calls"] or c["gram_eval_cuda_calls"]
            or c["gram_bwd_kernel_launches"] != c["gram_autograd_calls"]):
        raise AssertionError(f"{tag}: batched kernels not launched, or a Gram bypassed them: {c}")


def phase_restarts(device, main_res, dense_res, free_res):
    """Multi-start fits (``[restarts]`` lines): the bench's sparse request at
    full width with ``restarts=4``, graphed, cold and warm (the ``10k``
    gates, identical results, the sum of layer NLLs at most the
    ``restarts=1`` fit's of phase 3 plus 1e-3 of its magnitude); the sparse
    joint fit with ``restarts=2`` at full width, its depth cut to
    ``JOINT_RESTART_DEPTH`` outputs, against the SMSE gates; the dense model with
    ``restarts=2`` at the largest bucket whose memory, reckoned from the
    memory phase 4's graphed single-start step pins at 11 840 rows times
    2 (n_b / 11 840)^2, stays under 24 GiB.  Each run's wall-clock, batched launches of both
    kernels, host reads, escalations and peak memory; the graphed one's
    pinned memory."""
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.ops import gram_kernel as GK
    from gpar_torch.utils.metrics import smse

    P = "[restarts]"
    gpar_torch.config.epsilon = 1e-6
    n, p, n_test, iters, R = 10_000, 16, 1024, 10, 4
    x, y, f = make_data(n, p)
    test_idx = np.arange(len(x))[:: max(1, len(x) // n_test)][:n_test]
    x_test, f_test = x[test_idx], f[test_idx]
    reg = GPARRegressor(**model_kwargs(x), device=device)
    reg.condition(x, y)
    reg._ensure_vars(reg.p)
    z_init = reg.vs.snapshot()

    def run():
        reg.vs.restore(z_init)
        gen = torch.Generator(device).manual_seed(0)
        out, wall, peak, c = launches_checked(
            f"restarts={R}", lambda: reg.fit_predict(x, y, x_test, iters=iters, num_samples=100,
                                                     credible_bounds=True, generator=gen, restarts=R),
            backward=True)
        return out, wall, dict(reg.last_fit_report, peak_gib=peak), c

    res = {}
    before = reserved_bytes()
    cold = run()
    pinned = reserved_bytes() - before
    warm = run()
    for tag, (out, wall, rep, c) in (("graphed cold", cold), ("graphed warm", warm)):
        q = check_quality(P, f"restarts={R} {tag}", out, rep, f_test)
        check_batched_counts(tag, c)
        if rep["restarts"] != R or rep["graph_replays"] <= 0:
            raise AssertionError(f"{tag}: not a graphed fit with {R} restarts: {rep}")
        bound = reg.p * iters + rep["linesearch_trials"] + rep["linesearch_episodes"] + 1
        if rep["host_syncs"] > bound:
            raise AssertionError(f"{tag}: {rep['host_syncs']} host reads, more than {bound}")
        res[tag] = dict(q, wall_s=wall, fit_s=rep["wall_clock_s"], capture_s=rep["capture_s"],
                        host_syncs=rep["host_syncs"], linesearch_trials=rep["linesearch_trials"],
                        linesearch_episodes=rep["linesearch_episodes"],
                        ladder_escalations=rep["ladder_escalations"], peak_gib=rep["peak_gib"],
                        launches=c["gram_kernel_launches"], batched_launches=c["gram_batched_kernel_launches"],
                        bwd_launches=c["gram_bwd_kernel_launches"],
                        bwd_batched_launches=c["gram_bwd_batched_kernel_launches"],
                        graph_replays=rep["graph_replays"], layer_iters=rep["layer_iters"].tolist())
        print(f"{P} restarts={R} {tag}: fit_predict {wall:.3f} s (fit {rep['wall_clock_s']:.3f} s, capture "
              f"{rep['capture_s']:.3f} s); peak device memory {rep['peak_gib']:.2f} GiB; host reads "
              f"{rep['host_syncs']} (bound {bound}: {reg.p} layers x {iters} iterations + backtracking rounds "
              f"{rep['linesearch_trials']} + episodes {rep['linesearch_episodes']} + 1); factorisations past "
              f"the first jitter rung {rep['ladder_escalations']} (each element counted); gram launches "
              f"{c['gram_kernel_launches']} ({c['gram_batched_kernel_launches']} batched), backward launches "
              f"{c['gram_bwd_kernel_launches']} ({c['gram_bwd_batched_kernel_launches']} batched) for "
              f"{c['gram_autograd_calls']} Grams under autograd, plain-route CUDA Grams "
              f"{c['gram_plain_cuda_calls']}, gram_eval on CUDA {c['gram_eval_cuda_calls']}")
    res["pinned_gib"] = pinned / 2**30
    identical = (np.array_equal(cold[2]["layer_nll"], warm[2]["layer_nll"])
                 and all(np.array_equal(a, b) for a, b in zip(cold[0], warm[0])))
    one, many = main_res["scan_nll"], res["graphed warm"]["nll"]
    limit = one + 1e-3 * abs(one)
    print(f"{P} the cached graphed step with {R} restarts pins {res['pinned_gib']:.2f} GiB (restarts=1: "
          f"{main_res['pinned_gib']:.2f} GiB); cold and warm identical: {identical}; sum of layer NLLs "
          f"{many!r} against restarts=1's {one!r} (limit {limit!r})")
    if not identical or many > limit:
        raise AssertionError(f"restarts={R}: cold and warm differ, or the sum of layer NLLs {many} is above "
                             f"{limit}")

    # The sparse joint fit, two starts per position, at full width with its
    # depth cut to the first 8 outputs: its layer evaluations grow as the
    # square of the depth (91 s at p = 16 on an H100).
    pj = JOINT_RESTART_DEPTH
    reg2 = GPARRegressor(**model_kwargs(x), compat=False, device=device)
    gen = torch.Generator(device).manual_seed(1)
    _, fit_s, peak, c = launches_checked(
        "joint fit restarts=2",
        lambda: reg2.fit(x, y[:, :pj], fix=False, iters=iters, restarts=2, generator=gen), backward=True)
    check_batched_counts("joint fit restarts=2", c)
    rep = reg2.last_fit_report
    mean = reg2.predict(x_test, num_samples=100, generator=torch.Generator(device).manual_seed(0))
    sm = smse(mean, f_test[:, :pj])
    res["joint"] = dict(p=pj, fit_s=fit_s, peak_gib=peak, host_syncs=rep["host_syncs"],
                        linesearch_trials=rep["linesearch_trials"], ladder_escalations=rep["ladder_escalations"],
                        layer_iters=rep["layer_iters"].tolist(), layer_nll_last=float(rep["layer_nll"][-1]),
                        launches=c["gram_kernel_launches"], batched_launches=c["gram_batched_kernel_launches"],
                        bwd_launches=c["gram_bwd_kernel_launches"],
                        bwd_batched_launches=c["gram_bwd_batched_kernel_launches"],
                        mean_smse=float(np.nanmean(sm)), worst_smse=float(np.nanmax(sm)))
    print(f"{P} sparse joint fit (fix=False, restarts=2, full width, depth cut to p = {pj}): {fit_s:.3f} s; "
          f"peak device memory {peak:.2f} GiB; host reads {rep['host_syncs']}; escalations "
          f"{rep['ladder_escalations']}; iterations per position {res['joint']['layer_iters']}; last "
          f"position's NLL {res['joint']['layer_nll_last']!r} (restarts=1 at p = 16, phase 7: "
          f"{free_res['sparse']['layer_nll_last']!r}); gram launches {c['gram_kernel_launches']} "
          f"({c['gram_batched_kernel_launches']} batched), backward {c['gram_bwd_kernel_launches']} "
          f"({c['gram_bwd_batched_kernel_launches']} batched); SMSE mean {res['joint']['mean_smse']:.3e}, "
          f"worst {res['joint']['worst_smse']:.3e}")
    if (not np.isfinite(mean).all() or res["joint"]["mean_smse"] > GATES["mean_smse"]
            or res["joint"]["worst_smse"] > GATES["worst_smse"]):
        raise AssertionError("joint fit restarts=2: non-finite predictions or SMSE above the gates")
    del reg2

    # The dense model, two starts per layer, at the largest bucket whose
    # reckoned memory stays under the limit: the graphed step's pinned
    # memory (its graphs' pools hold the (rows, rows) temporaries, which the
    # allocator's peak does not count) scales with the batch and rows^2.
    per_n2 = dense_res["pinned_gib"] / 11_840**2
    n_b, reckoned = largest_bucket(lambda b: 2 * per_n2 * b * b)
    nd = rows_for_bucket(n_b)
    xd, yd, fd = make_data(nd, p, seed=3)
    kw = dict(model_kwargs(xd), x_ind=None)
    regd = GPARRegressor(**kw, device=device)
    gen = torch.Generator(device).manual_seed(2)
    before = reserved_bytes()
    _, fit_s, peak, c = launches_checked(
        "dense restarts=2", lambda: regd.fit(xd, yd, iters=iters, restarts=2, generator=gen), backward=True)
    pinned_d = reserved_bytes() - before
    check_batched_counts("dense restarts=2", c)
    rep = regd.last_fit_report
    if not np.isfinite(rep["layer_nll"]).all() or rep["graph_replays"] <= 0:
        raise AssertionError(f"dense restarts=2: non-finite NLLs or no graph replays: {rep}")
    res["dense"] = dict(n=nd, bucket=n_b, reckoned_gib=reckoned, fit_s=fit_s, capture_s=rep["capture_s"],
                        peak_gib=peak, pinned_gib=pinned_d / 2**30, host_syncs=rep["host_syncs"],
                        ladder_escalations=rep["ladder_escalations"], layer_iters=rep["layer_iters"].tolist(),
                        nll0=float(np.sum(rep["layer_nll0"])), nll=float(np.sum(rep["layer_nll"])),
                        launches=c["gram_kernel_launches"], batched_launches=c["gram_batched_kernel_launches"],
                        bwd_launches=c["gram_bwd_kernel_launches"],
                        bwd_batched_launches=c["gram_bwd_batched_kernel_launches"])
    print(f"{P} dense restarts=2 at n = {nd} (bucket {n_b}: reckoned {reckoned:.2f} GiB from the "
          f"{dense_res['pinned_gib']:.2f} GiB phase 4's graphed step pins at 11 840 rows): graphed fit "
          f"{fit_s:.3f} s (capture "
          f"{rep['capture_s']:.3f} s); peak device memory {peak:.2f} GiB, pinned {pinned_d / 2**30:.2f} GiB; "
          f"sum NLL {res['dense']['nll0']:.1f} -> {res['dense']['nll']:.1f}; host reads {rep['host_syncs']}; "
          f"escalations {rep['ladder_escalations']}; gram launches {c['gram_kernel_launches']} "
          f"({c['gram_batched_kernel_launches']} batched), backward {c['gram_bwd_kernel_launches']} "
          f"({c['gram_bwd_batched_kernel_launches']} batched)")
    del regd
    from gpar_torch.models.graphs import clear_cache

    clear_cache()
    return res


def phase_batched_fit(device, dense_res):
    """``fused="batched"`` (``[batched]`` lines): the dense model with
    ``replace=False`` on fully observed data, p = 16, every layer's L-BFGS as
    one batch of 16, against the scan fit (``fused=True``, graphed) on the
    same data, at the largest bucket whose peak, reckoned from phase 4's
    measured eager-step peak at its bucket b_e (4800 rows) times
    16 (n_b / b_e)^2,
    stays under 24 GiB: at ``iters=0`` the layer NLLs at the initial
    latents agree to 1e-5 of their largest (the same objective in
    float32); after 10 iterations the gap is printed, not held: float32
    L-BFGS trajectories part once a factorisation's rounding moves the
    jitter ladder to another rung (both routes' escalations are printed),
    and the ``[small]`` phase holds the two routes to each other in
    float64 on the card after their iterations instead.  Both
    wall-clocks, the launch counts, and JAX's ``ValueError`` for every
    broken precondition."""
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor

    P = "[batched]"
    gpar_torch.config.epsilon = 1e-6
    p, iters = 16, 10
    per_n2 = dense_res["peak_gib_eager"] / dense_res["eager_rows"]**2
    n_b, reckoned = largest_bucket(lambda b: p * per_n2 * b * b)
    n = rows_for_bucket(n_b)
    x, y, _ = make_data(n, p, seed=4)
    kw = dict(model_kwargs(x), x_ind=None, replace=False)
    res = dict(n=n, bucket=n_b, reckoned_gib=reckoned)
    for it, limit in ((0, 1e-5), (iters, None)):
        runs = {}
        for fused in ("batched", True):
            reg = GPARRegressor(**kw, device=device)
            _, fit_s, peak, c = launches_checked(
                f"fused={fused!r} iters={it}", lambda: reg.fit(x, y, iters=it, fused=fused), backward=True)
            rep = reg.last_fit_report
            if fused == "batched":
                check_batched_counts("fused='batched'", c)
            runs[fused] = dict(fit_s=fit_s, peak_gib=peak, layer_nll=rep["layer_nll"].tolist(),
                               layer_iters=rep["layer_iters"].tolist(), host_syncs=rep["host_syncs"],
                               ladder_escalations=rep["ladder_escalations"],
                               launches=c["gram_kernel_launches"],
                               batched_launches=c["gram_batched_kernel_launches"],
                               bwd_launches=c["gram_bwd_kernel_launches"],
                               bwd_batched_launches=c["gram_bwd_batched_kernel_launches"])
        a, b = np.asarray(runs["batched"]["layer_nll"]), np.asarray(runs[True]["layer_nll"])
        gap = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        res[f"iters{it}"] = dict(batched=runs["batched"], scan=runs[True], gap=gap, limit=limit)
        rb, rs = runs["batched"], runs[True]
        print(f"{P} dense replace=False p={p} n={n} (bucket {n_b}, reckoned peak {reckoned:.2f} GiB) "
              f"iters={it}: fused='batched' {rb['fit_s']:.3f} s (peak {rb['peak_gib']:.2f} GiB, host reads "
              f"{rb['host_syncs']}, gram launches {rb['launches']} ({rb['batched_launches']} batched), backward "
              f"{rb['bwd_launches']} ({rb['bwd_batched_launches']} batched)) against fused=True "
              f"{rs['fit_s']:.3f} s (peak {rs['peak_gib']:.2f} GiB, gram launches {rs['launches']}); "
              f"escalations {rb['ladder_escalations']} and {rs['ladder_escalations']}; largest layer-NLL gap "
              f"{gap:.3e} of the largest |NLL| ({'limit %g' % limit if limit else 'printed, not held'}); "
              f"layer NLLs batched {rb['layer_nll']}, scan {rs['layer_nll']}")
        if not np.isfinite(a).all() or (limit is not None and not gap <= limit):
            raise AssertionError(f"fused='batched' disagrees with fused=True at iters={it}: {gap:.3e}")
    # Every broken precondition raises JAX's error.
    xs, ys, _ = make_data(40, 3, seed=5)
    yn = ys.copy()
    yn[3, 1] = np.nan
    broken = {"a dense model": (dict(x_ind=np.linspace(0, 10, 5)), ys),
              "replace=False": (dict(replace=True), ys), "scale_tie=False": (dict(scale_tie=True), ys),
              "fully-observed data": ({}, yn)}
    for what, (extra, yy) in broken.items():
        reg = GPARRegressor(**dict(dict(noise=0.1, x_ind=None, replace=False), **extra), device=device)
        try:
            reg.fit(xs, yy, iters=1, fused="batched")
        except ValueError as e:
            if str(e) != f"batched layer fits require {what}":
                raise
        else:
            raise AssertionError(f"fused='batched' without {what} did not raise")
    print(f"{P} fused='batched' raises JAX's ValueError for each of: {', '.join(broken)}")
    return res


def phase_mesh(device, main_res):
    """The device mesh (``[mesh]`` lines) on a virtual mesh of the card four
    times over, ``make_mesh(4, devices=[cuda] * 4)``: every sharded route
    runs its per-shard algebra at full width, each shard's Grams through the
    forward kernel and their gradients through the backward kernel.

    - The bench's sparse request (phase 3's model and data, float32) under
      ``mesh=``: ``fit_predict`` cold and warm, graphed (one shard's Kmn is
      256 x 2960), held to the ``10k`` gates, the same bits twice, the sum
      of layer NLLs within 1e-3 relative of phase 3's single-device scan
      fit, the launch checks and the host reads; then, at the fitted
      latents, the predictive mean from the same normals with and without
      the mesh (the samples split over the shards), and the prior and
      posterior scores of ``make_data(2000, 16, seed=500)`` with and without
      it (1e-4 relative where the float32 score is a rounding of the
      float64 one; otherwise printed, ``UNHELD_GAP``).
    - The dense model at n = 2000 (cut from 10 000: each evaluation's
      backward forms all of ``L^-1``), fit, predict and scores through the
      distributed blocked Cholesky and its backward, against the
      single-device route (sum of layer NLLs within 1e-3 relative; the
      float32 scores printed, ``UNHELD_GAP``); the share of one layer
      evaluation's device time spent in the
      distributed factorisation and its backward.
    - float64 at n = 2000, p = 4, sparse and dense: fit (5 iterations),
      predict and both scores under the mesh against the single-device
      route on the card, 1e-8 relative."""
    import torch

    from gpar_torch import GPARRegressor
    from gpar_torch.models import fused as TF
    from gpar_torch.ops import gram_kernel as GK
    from gpar_torch.parallel import make_mesh

    P = "[mesh]"
    mesh = make_mesh(4, devices=[torch.device(device)] * 4)
    out = {}
    n, p, n_test, num_samples, iters = 10_000, 16, 1024, 100, 10
    x, y, f = make_data(n, p)
    test_idx = np.arange(n)[:: n // n_test][:n_test]
    x_test, f_test = x[test_idx], f[test_idx]
    xs, ys, _ = make_data(2000, p, seed=500)

    def request(reg, z0, x, y, x_test, **kw):
        reg.vs.restore(z0)
        gen = torch.Generator(device).manual_seed(0)
        return launches_checked("mesh request", lambda: reg.fit_predict(
            x, y, x_test, iters=iters, num_samples=num_samples, credible_bounds=True, generator=gen,
            **kw), backward=True)

    # The sparse bench request.
    reg = GPARRegressor(**model_kwargs(x), device=device)
    reg.condition(x, y)
    reg._ensure_vars(p)
    z_init = reg.vs.snapshot()
    runs = {}
    for tag in ("cold", "warm"):
        res, wall, peak, c = request(reg, z_init, x, y, x_test, mesh=mesh)
        rep = reg.last_fit_report
        q = check_quality(P, f"sparse {tag}", res, rep, f_test)
        bound = int(np.sum(rep["layer_iters"])) + rep["linesearch_trials"] + rep["linesearch_episodes"] + 1
        rel = abs(q["nll"] - main_res["scan_nll"]) / abs(main_res["scan_nll"])
        print(f"{P} sparse {tag}: fit_predict {wall:.3f} s (fit {rep['wall_clock_s']:.3f} s; phase 3's "
              f"single-device warm {main_res['warm_s']:.3f} s, fit {main_res['warm_fit_s']:.3f} s); capture "
              f"{rep['capture_s']:.3f} s; graph replays {rep['graph_replays']}; host reads "
              f"{rep['host_syncs']} (bound {bound}); peak {peak:.2f} GiB; gram kernel launches "
              f"{c['gram_kernel_launches']}, backward {c['gram_bwd_kernel_launches']} for "
              f"{c['gram_autograd_calls']} Grams under autograd, gram_eval on CUDA "
              f"{c['gram_eval_cuda_calls']}; sum of layer NLLs {q['nll']:.3f} against the single-device "
              f"{main_res['scan_nll']:.3f} (relative {rel:.2e})")
        if rep["graph_replays"] <= 0 or rep["host_syncs"] > bound:
            raise AssertionError(f"sparse {tag}: replays {rep['graph_replays']}, host reads "
                                 f"{rep['host_syncs']} (bound {bound})")
        if rel > 1e-3:
            raise AssertionError(f"sparse {tag}: sum of layer NLLs {rel:.2e} from the single-device fit")
        runs[tag] = (res, rep, wall, c)
    same = (np.array_equal(runs["cold"][1]["layer_nll"], runs["warm"][1]["layer_nll"])
            and all(np.array_equal(a, b) for a, b in zip(runs["cold"][0], runs["warm"][0])))
    print(f"{P} sparse cold and warm identical: {same}")
    if not same:
        raise AssertionError("the mesh request is not deterministic")
    normals = torch.randn((p, num_samples, n_test), generator=torch.Generator(device).manual_seed(1),
                          device=device)
    m_mesh = reg.predict(x_test, num_samples=num_samples, normals=normals, mesh=mesh)
    m_one = reg.predict(x_test, num_samples=num_samples, normals=normals)
    d_mean = float(np.max(np.abs(m_mesh - m_one)))
    print(f"{P} sparse predictive mean from the same normals, samples split over 4 shards against one "
          f"device: max |d| {d_mean:.3e} (max |mean| {float(np.max(np.abs(m_one))):.3e})")
    if d_mean > 1e-4 * max(1.0, float(np.max(np.abs(m_one)))):
        raise AssertionError(f"the split predictive differs from the single-device tail by {d_mean:.3e}")
    scores = {}
    for post in (False, True):
        (s_mesh, wall, _, c) = launches_checked("mesh score", lambda: reg.logpdf(
            xs, ys, posterior=post, mesh=mesh), backward=False)
        s_one = reg.logpdf(xs, ys, posterior=post)
        rel = abs(s_mesh - s_one) / abs(s_one)
        scores["posterior" if post else "prior"] = dict(mesh=s_mesh, single=s_one, s=wall,
                                                        launches=c["gram_kernel_launches"])
        why = UNHELD_GAP.get(("sparse", post, reg.compat))
        print(f"{P} sparse {'posterior' if post else 'prior'} score of 2000 rows: {s_mesh:.3f} under the "
              f"mesh ({wall:.3f} s, {c['gram_kernel_launches']} Gram launches), {s_one:.3f} on one device "
              f"(relative {rel:.2e}; " + (f"printed, not held: {why})" if why else "held to 1e-4)"))
        if not np.isfinite(s_mesh) or (why is None and rel > 1e-4):
            raise AssertionError(f"sparse score under the mesh {rel:.2e} from one device's")
    c_cold = runs["cold"][3]
    out["sparse"] = dict(cold_s=runs["cold"][2], warm_s=runs["warm"][2],
                         warm_fit_s=runs["warm"][1]["wall_clock_s"], nll=float(np.sum(runs["warm"][1]["layer_nll"])),
                         host_syncs=runs["warm"][1]["host_syncs"], launches=c_cold["gram_kernel_launches"],
                         bwd_launches=c_cold["gram_bwd_kernel_launches"], predict_max_d=d_mean, scores=scores)
    del reg

    # The dense model at n = 2000.
    xd, yd, fd = make_data(2000, p, seed=3)
    td = np.arange(2000)[:: 2000 // 256][:256]
    kw = dict(model_kwargs(xd), x_ind=None)
    dense = {}
    for name, ctx in (("single", {}), ("mesh", {"mesh": mesh})):
        dreg = GPARRegressor(**kw, device=device)
        dreg.condition(xd, yd)
        dreg._ensure_vars(p)
        res, wall, peak, c = request(dreg, dreg.vs.snapshot(), xd, yd, xd[td], **ctx)
        q = check_quality(P, f"dense n=2000 {name}", res, dreg.last_fit_report, fd[td], gates=False)
        s = [dreg.logpdf(xs, ys, posterior=post, **ctx) for post in (False, True)]
        dense[name] = dict(q=q, wall=wall, fit_s=dreg.last_fit_report["wall_clock_s"], peak=peak,
                           launches=c["gram_kernel_launches"], bwd_launches=c["gram_bwd_kernel_launches"],
                           scores=s, reg=dreg)
        print(f"{P} dense n=2000 {name}: fit_predict {wall:.3f} s (fit {dense[name]['fit_s']:.3f} s); "
              f"peak {peak:.2f} GiB; gram launches {c['gram_kernel_launches']}, backward "
              f"{c['gram_bwd_kernel_launches']}; scores prior {s[0]:.3f}, posterior {s[1]:.3f}")
    rel = abs(dense["mesh"]["q"]["nll"] - dense["single"]["q"]["nll"]) / abs(dense["single"]["q"]["nll"])
    srel = max(abs(a - b) / abs(b) for a, b in zip(dense["mesh"]["scores"], dense["single"]["scores"]))
    print(f"{P} dense n=2000: sum of layer NLLs {dense['mesh']['q']['nll']:.3f} under the mesh against "
          f"{dense['single']['q']['nll']:.3f} (relative {rel:.2e}, held to 1e-3); scores relative "
          f"{srel:.2e} (printed, not held: {UNHELD_GAP[('dense', False, True)]})")
    if rel > 1e-3 or not np.all(np.isfinite(dense["mesh"]["scores"])):
        raise AssertionError(f"dense under the mesh: NLL {rel:.2e} from one device, scores "
                             f"{dense['mesh']['scores']}")

    # One evaluation (value and gradient) of the dense layer objective at
    # the mesh fit's latents, layer 0, and the distributed factorisation
    # with its backward alone on that evaluation's covariance shards.
    dreg = dense["mesh"]["reg"]
    names = dreg.vs.select(None)
    plan = dreg._scan_fit_plan(names)
    x_pad, rows = dreg._bucket_fit_inputs(plan)
    xs_all = TF.plan_tensors(plan, x_pad.dtype, x_pad.device, rows=rows)
    x_parts, xs_parts, block = TF._mesh_split(plan, x_pad, xs_all, mesh)
    x_aug = [TF._widen(a, plan.W) for a in x_parts]
    lins = [{k: v[0] for k, v in part.items()} for part in xs_parts]
    z_ext = torch.cat([dreg.vs.latent_vector(names), x_pad.new_zeros(1)])
    zi = x_pad.new_zeros((0, plan.W))
    seen = []
    real = TF.chol_logpdf
    TF.chol_logpdf = lambda A, r, m, b: (seen.append((A, r, m, b)), real(A, r, m, b))[1]
    try:
        def evaluation():
            z = z_ext.detach().requires_grad_(True)
            TF._mesh_layer_nll_factors(plan, lins, z, x_aug, zi, block)[0].backward()

        evaluation()
    finally:
        TF.chol_logpdf = real
    A, r, m, b = seen[0]
    A = [a.detach().requires_grad_(True) for a in A]
    eval_ms = device_ms(evaluation, 5)
    chol_ms = device_ms(lambda: real(A, r, m, b)[0].backward(), 5)
    print(f"{P} dense n=2000 one layer evaluation (value and gradient, rows 2432 padded to 4 x "
          f"{x_parts[0].shape[0]}, panel {block}): {eval_ms:.3f} ms device; the distributed Cholesky, "
          f"solves and backward alone {chol_ms:.3f} ms ({100 * chol_ms / eval_ms:.1f} %)")
    out["dense"] = dict({k: dict(nll=v["q"]["nll"], s=v["wall"], fit_s=v["fit_s"], peak_gib=v["peak"],
                                 launches=v["launches"], bwd_launches=v["bwd_launches"], scores=v["scores"])
                         for k, v in dense.items()}, eval_ms=eval_ms, chol_ms=chol_ms)
    del dense, dreg, seen, A

    # float64 at n = 2000, p = 4: under the mesh against one device.
    x4, y4, _ = make_data(2000, 4, seed=9)
    x4, y4 = x4.astype(np.float64), y4.astype(np.float64)
    y4[::13, 2] = np.nan
    xt4 = np.linspace(0.2, 9.8, 200)
    nrm = np.random.default_rng(2).standard_normal((4, 16, 200))
    for model in ("sparse", "dense"):
        kw = model_kwargs(x4) if model == "sparse" else dict(model_kwargs(x4), x_ind=None)
        got = {}
        for name, ctx in (("single", {}), ("mesh", {"mesh": mesh})):
            r64 = GPARRegressor(**kw, device=device, dtype=torch.float64)
            r64.fit(x4, y4, iters=5, **ctx)
            got[name] = [r64.last_fit_report["layer_nll"],
                         r64.predict(xt4, num_samples=16, normals=nrm, **ctx),
                         np.asarray([r64.logpdf(xs[:, None].astype(np.float64), ys[:, :4].astype(np.float64),
                                                posterior=post, **ctx) for post in (False, True)])]
        worst = 0.0
        for a, b in zip(got["mesh"], got["single"]):
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * float(np.max(np.abs(b))))
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))))
        print(f"{P} float64 {model} n=2000 p=4: fit (5 iterations), predict and both scores under the mesh "
              f"== one device on the card (rtol 1e-8; largest relative difference {worst:.2e})")
        out[f"float64 {model}"] = worst
    return out


def phase_small_agreement():
    import torch

    from gpar_torch import GPARRegressor

    rng = np.random.default_rng(4)
    x, y, _ = make_data(100, 3, seed=4)
    x, y = x.astype(np.float64), y.astype(np.float64)
    xt = np.linspace(0.3, 9.7, 15)
    normals = rng.standard_normal((3, 8, 15))
    for model, n_ind, replace in (("sparse", 8, True), ("dense", None, True), ("sparse", 8, False),
                                  ("dense", None, False)):
        kw = dict(model_kwargs(x, n_ind=n_ind or 8), replace=replace)
        if n_ind is None:
            kw["x_ind"] = None
        outs = {}
        for dev in ("cuda", "cpu"):
            reg = GPARRegressor(**kw, device=dev, dtype=torch.float64)
            res = reg.fit_predict(x, y, xt, iters=5, num_samples=8, credible_bounds=True, normals=normals)
            rep = reg.last_fit_report
            assert rep["fused"] and (rep["graph_replays"] > 0) == (dev == "cuda"), rep
            outs[dev] = (res, reg.vs.snapshot(), rep["layer_nll"])
        (rc, lc, nc), (rh, lh, nh) = outs["cuda"], outs["cpu"]
        np.testing.assert_allclose(nc, nh, rtol=1e-6)
        for k in lh:
            np.testing.assert_allclose(lc[k], lh[k], rtol=1e-6, atol=1e-8)
        for a, b in zip(rc, rh):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
        print(f"[small] float64 {model} replace={replace} scan-path fit_predict, graphed on cuda == eager "
              f"on cpu (rtol 1e-6): layer NLL {nc.tolist()}")
    # The joint fit and the scores after it, the same way.
    xs, ys, _ = make_data(60, 3, seed=7)
    xs, ys = xs.astype(np.float64), ys.astype(np.float64)
    ys[::7, 1] = np.nan
    for model, n_ind in (("sparse", 8), ("dense", None)):
        kw = model_kwargs(x, n_ind=n_ind or 8)
        if n_ind is None:
            kw["x_ind"] = None
        outs = {}
        for dev in ("cuda", "cpu"):
            reg = GPARRegressor(**kw, device=dev, dtype=torch.float64)
            reg.fit(x, y, fix=False, iters=3)
            scores = [reg.logpdf(xs, ys, posterior=post) for post in (False, True)]
            outs[dev] = (reg.last_fit_report["layer_nll"], reg.vs.snapshot(), scores)
        (nc, lc, sc), (nh, lh, sh) = outs["cuda"], outs["cpu"]
        np.testing.assert_allclose(nc, nh, rtol=1e-6)
        for k in lh:
            np.testing.assert_allclose(lc[k], lh[k], rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(sc, sh, rtol=1e-6)
        print(f"[small] float64 {model} fit(fix=False) and its prior and posterior scores, on cuda == on cpu "
              f"(rtol 1e-6): layer NLL {nc.tolist()}, scores {sc}")
    # Restarts: the scan step's R starts as one batch (graphed) against the
    # per-layer driver's R starts one after the other, both on the card,
    # from the same normals in each route's shape (a layer's padded span
    # lists its latents in the driver's order, so the driver takes the
    # scan's normals cut to the layer's width).
    R = 3
    for model, n_ind in (("sparse", 8), ("dense", None)):
        kw = model_kwargs(x, n_ind=n_ind or 8)
        if n_ind is None:
            kw["x_ind"] = None
        reg = GPARRegressor(**kw, device="cuda", dtype=torch.float64)
        reg.condition(x, y)
        reg._ensure_vars(reg.p)
        s_max = reg._scan_fit_plan(reg.vs.select(None)).s_max
        widths = [int(reg.vs.latent_vector(reg.vs.select([f"{pi}/*"])).shape[0]) for pi in range(reg.p)]
        normals = rng.standard_normal((reg.p, R - 1, s_max))
        outs = {}
        for fused, nrm in ((True, list(normals)), (False, [a[:, :w] for a, w in zip(normals, widths)])):
            r2 = GPARRegressor(**kw, device="cuda", dtype=torch.float64)
            r2.fit(x, y, iters=5, restarts=R, fused=fused, restart_normals=nrm)
            rep = r2.last_fit_report
            assert rep["restarts"] == R and (rep["graph_replays"] > 0) == fused, rep
            outs[fused] = (rep["layer_nll"], r2.vs.snapshot())
        (nc, lc), (nh, lh) = outs[True], outs[False]
        np.testing.assert_allclose(nc, nh, rtol=1e-6)
        for k in lh:
            np.testing.assert_allclose(lc[k], lh[k], rtol=1e-6, atol=1e-8)
        print(f"[small] float64 {model} restarts={R}: the graphed scan's batched starts == the per-layer "
              f"driver's sequential starts, both on cuda (rtol 1e-6): layer NLL {nc.tolist()}")
    # fused="batched" against the graphed scan fit, float64, on the card:
    # the dense replace=False model on fully observed data, one start and
    # two (the same normals: both routes take (R - 1, s_max) per layer).
    kw = dict(model_kwargs(x), x_ind=None, replace=False)
    for R in (1, 2):
        outs = {}
        for fused in (True, "batched"):
            reg = GPARRegressor(**kw, device="cuda", dtype=torch.float64)
            reg.condition(x, y)
            reg._ensure_vars(reg.p)
            s_max = reg._scan_fit_plan(reg.vs.select(None)).s_max
            normals = list(np.random.default_rng(8).standard_normal((reg.p, R - 1, s_max)))
            reg.fit(x, y, iters=5, fused=fused, restarts=R, restart_normals=normals if R > 1 else None)
            outs[fused] = (reg.last_fit_report["layer_nll"], reg.vs.snapshot())
        (nc, lc), (nh, lh) = outs["batched"], outs[True]
        np.testing.assert_allclose(nc, nh, rtol=1e-6)
        for k in lh:
            np.testing.assert_allclose(lc[k], lh[k], rtol=1e-6, atol=1e-8)
        print(f"[small] float64 dense replace=False restarts={R}: fused='batched' == the graphed scan fit, "
              f"both on cuda (rtol 1e-6): layer NLL {nc.tolist()}")


#: The fixed permutation of the bench's columns that the greedy phase's
#: search must undo or reorder (numpy.random.default_rng(11)).
GREEDY_PERM_SEED = 11


def greedy_lines(P, tag, reg, counts, fit_s, predict_s, peak):
    """Print a greedy fit's order, search wall-clock, its per-position host
    reads and rounds of trials and the scorer's launches; returns them."""
    g = reg.last_greedy_report
    order = [int(o) for o in reg.order]
    is_perm = sorted(order) == list(range(len(order)))
    reads = [p["host_syncs"] for p in g["positions"]]
    trials = [p["linesearch_trials"] for p in g["positions"]]
    print(f"{P} {tag}: order {order} (a permutation: {is_perm}); greedy search {g['wall_clock_s']:.3f} s, "
          f"fit after it {reg.last_fit_report['wall_clock_s']:.3f} s (fit() {fit_s:.3f} s in all), predict "
          f"{predict_s:.3f} s; peak device memory {peak:.2f} GiB")
    print(f"{P} {tag}: per position host reads {reads}, rounds of backtracking trials {trials}, "
          f"escalated factorisations {[p['ladder_escalations'] for p in g['positions']]}; the scorer's "
          f"batched launches: forward {counts['gram_batched_kernel_launches']} (of "
          f"{counts['gram_kernel_launches']}), backward {counts['gram_bwd_batched_kernel_launches']} (of "
          f"{counts['gram_bwd_kernel_launches']}); plain CUDA Grams {counts['gram_plain_cuda_calls']}, "
          f"gram_eval on CUDA {counts['gram_eval_cuda_calls']}")
    if not is_perm:
        raise AssertionError(f"{tag}: the greedy order is not a permutation: {order}")
    check_batched_counts(f"{tag} greedy search", counts)
    if counts["gram_batched_kernel_launches"] != counts["gram_kernel_launches"]:
        raise AssertionError(f"{tag}: a scorer Gram was not one batched launch: {counts}")
    return dict(order=order, greedy_s=g["wall_clock_s"], fit_after_s=reg.last_fit_report["wall_clock_s"],
                fit_s=fit_s, predict_s=predict_s, peak_gib=peak, host_syncs=reads, trials=trials,
                escalations=[p["ladder_escalations"] for p in g["positions"]],
                batched_launches=counts["gram_batched_kernel_launches"],
                bwd_batched_launches=counts["gram_bwd_batched_kernel_launches"],
                gram_eval_calls=counts["gram_eval_cuda_calls"], plain_calls=counts["gram_plain_cuda_calls"])


def greedy_request(reg, x, y, x_test, device):
    """``fit(greedy=True, iters=10)`` on the graphed scan route, then a
    100-sample ``predict`` with credible bounds; the scorer's Gram counters
    are read around the search alone.  Returns ``(out, fit_s, predict_s,
    peak_gib, scorer counters, fit counters)``."""
    import torch

    from gpar_torch.ops import gram_kernel as GK

    search = type(reg)._greedy_order
    scorer = {}

    def spy(*a):
        GK.reset_counters()
        order = search(reg, *a)
        torch.cuda.synchronize()
        scorer.update(GK.counters())
        GK.reset_counters()
        return order

    reg._greedy_order = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reg.fit(x, y, greedy=True, iters=10)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = GK.counters()
    t0 = time.perf_counter()
    out = reg.predict(x_test, num_samples=100, credible_bounds=True,
                      generator=torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    del reg._greedy_order
    return out, fit_s, predict_s, torch.cuda.max_memory_allocated() / 2**30, scorer, fit_counts


def phase_greedy(device):
    """Greedy output ordering at full width (``[greedy]`` lines): the bench's
    model with ``compat=False`` on ``make_data(10 000, 16)`` whose columns
    are shuffled by a fixed permutation, ``fit(greedy=True, iters=10)`` on
    the graphed scan route and a 100-sample ``predict`` with credible
    bounds, cold and warm (the same order and the same bits), held to the
    ``10k`` gates in the original columns; then the dense model
    (``x_ind=None``) on ``make_data(2000, 16, seed=500)`` (bucket 2432),
    once.  Every scorer Gram must be one batched launch of the forward
    kernel and every gradient one of the backward, with no plain-route
    Gram and no ``gram_eval`` on the card."""
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor

    P = "[greedy]"
    gpar_torch.config.epsilon = 1e-6
    perm = np.random.default_rng(GREEDY_PERM_SEED).permutation(16)
    res = {"permutation": perm.tolist()}
    x, y, f = make_data(10_000, 16)
    y, f = y[:, perm], f[:, perm]
    test_idx = np.arange(len(x))[:: max(len(x) // 1024, 1)][:1024]
    runs = []
    for tag in ("sparse cold", "sparse warm"):
        reg = GPARRegressor(**model_kwargs(x), compat=False, device=device)
        out, fit_s, predict_s, peak, scorer, fit_counts = greedy_request(reg, x, y, x[test_idx], device)
        res[tag] = greedy_lines(P, tag, reg, scorer, fit_s, predict_s, peak)
        res[tag]["quality"] = check_quality(P, tag + " (original columns)", out, reg.last_fit_report,
                                            f[test_idx])
        res[tag]["fit_launches"] = fit_counts["gram_kernel_launches"]
        if fit_counts["gram_plain_cuda_calls"] or fit_counts["gram_eval_cuda_calls"]:
            raise AssertionError(f"{tag}: the fit after the search bypassed the kernel: {fit_counts}")
        runs.append((res[tag]["order"], out))
    same = runs[0][0] == runs[1][0] and all(np.array_equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    print(f"{P} sparse cold and warm: the same order and the same bits: {same}; the order undoes the "
          f"shuffle {perm.tolist()} into original columns {[int(perm[o]) for o in runs[0][0]]}")
    if not same:
        raise AssertionError("the greedy request is not deterministic")
    xd, yd, fd = make_data(2000, 16, seed=500)
    yd, fd = yd[:, perm], fd[:, perm]
    reg = GPARRegressor(**dict(model_kwargs(xd), x_ind=None), compat=False, device=device)
    out, fit_s, predict_s, peak, scorer, _ = greedy_request(reg, xd, yd, xd[::2], device)
    res["dense"] = greedy_lines(P, "dense n=2000 (bucket 2432)", reg, scorer, fit_s, predict_s, peak)
    res["dense"]["quality"] = check_quality(P, "dense n=2000 (original columns)", out, reg.last_fit_report,
                                            fd[::2], gates=False)
    return res


def phase_small_greedy():
    """The greedy search in float64 at n = 64, p = 4, sparse and dense, on
    the card and on the CPU in the same process (the plain versions of the
    kernels): the same order, per-position NLLs equal to rtol 1e-6."""
    import torch

    from gpar_torch import GPARRegressor

    x, y, _ = make_data(64, 4, seed=9)
    x, y = x.astype(np.float64), y[:, [2, 0, 3, 1]].astype(np.float64)
    y[::9, 3] = np.nan
    for model, n_ind in (("sparse", 8), ("dense", None)):
        kw = dict(model_kwargs(x, n_ind=n_ind or 8), compat=False)
        if n_ind is None:
            kw["x_ind"] = None
        outs = {}
        for dev in ("cuda", "cpu"):
            reg = GPARRegressor(**kw, device=dev, dtype=torch.float64)
            reg.condition(x, y)
            order = reg._greedy_order(15)
            outs[dev] = (order.tolist(), [p["nll"] for p in reg.last_greedy_report["positions"]])
        (oc, nc), (oh, nh) = outs["cuda"], outs["cpu"]
        if oc != oh:
            raise AssertionError(f"float64 greedy order on cuda {oc} != on cpu {oh}")
        for a, b in zip(nc, nh):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        print(f"[small] float64 {model} greedy search n=64 p=4, on cuda == on cpu: order {oc}, per-position "
              f"NLLs equal to rtol 1e-6 (position 0: {np.round(nc[0], 6).tolist()})")


#: The examples' configurations (ROADMAP A10.7): name -> (constructor
#: arguments beyond the noise, input width, transform, non-unit weights).
CONFIGS = {
    "exchange": (dict(scale=0.1, linear=True, linear_scale=10.0, nonlinear=True, rq=True, noise=0.01,
                      replace=False, compat=True), 1, None, True),
    "jura": (dict(scale=10.0, linear=False, nonlinear=True, noise=0.1, impute=False, replace=True,
                  compat=False), 2, "log", False),
    "ml": (dict(scale=1.0, linear=True, linear_scale=100.0, nonlinear=True, noise=0.01, replace=True,
                markov=1, scale_tie=True, compat=True), 6, None, False),
    "eeg": (dict(scale=0.02, linear=False, nonlinear=True, noise=0.01, replace=False, compat=False), 1,
            "squish", False),
    "periodic": (dict(per=True, per_period=3.0, per_decay=10.0, input_linear=True, input_linear_scale=10.0,
                      linear=True, linear_scale=10.0, noise=0.1, replace=True, normalise_y=False,
                      compat=False), 1, None, True),
}


def config_data(n, p, m, transform, seed):
    """A ``p``-output chain on ``m`` inputs with 10 % of the later outputs
    missing; positive for the log transform; non-unit weights."""
    r = np.random.default_rng(seed)
    x = r.uniform(0.0, 10.0, (n, m))
    t = x[:, 0] + 0.3 * x.sum(axis=1)
    cols = [np.sin(t)]
    for i in range(1, p):
        cols.append(np.cos(cols[-1]) ** 2 + np.sin((i + 1) * t / 3.0))
    y = np.stack(cols, axis=1) + 0.05 * r.standard_normal((n, p))
    if transform == "log":
        y = np.exp(y)
    y[:, 1:][r.uniform(size=(n, p - 1)) < 0.1] = np.nan
    return x, y, r.uniform(0.5, 2.0, (n, p))


def phase_configs(device):
    """The examples' configurations on the card (``[configs]`` lines): each
    of :data:`CONFIGS` at n = 2000, p = 4, sparse (64 inducing points) and
    dense, ``fit_predict`` (scan route, graphed, 5 iterations) and
    ``logpdf`` of other data (prior and posterior) in float32: finite
    results, every Gram through the kernels (the analyser's terms printed;
    no ``gram_eval`` and no plain-route Gram); then each at n = 96 in
    float64 on the card against the CPU, rtol 1e-6: the fit's layer NLLs,
    then predictions and scores at the CPU's fitted latents.  The
    examples' own sizes and data run in :func:`phase_examples`."""
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.models.regressor import _model_generator, log_transform, squishing_transform
    from gpar_torch.ops import gram_kernel as GK

    P = "[configs]"
    gpar_torch.config.epsilon = 1e-6
    transforms = {"log": log_transform, "squish": squishing_transform}
    res = {}

    def build(name, n_ind, dev, dtype):
        kw, m, transform, _ = CONFIGS[name]
        kw = dict(kw)
        if transform:
            kw["transform_y"] = transforms[transform]
        x_ind = np.random.default_rng(12).uniform(0.0, 10.0, (n_ind, m)) if n_ind else None
        return GPARRegressor(**kw, x_ind=x_ind, device=dev, dtype=dtype)

    def request(reg, name, n, seed, latents=None):
        """Fit, then (at ``latents`` if given) predict and score; returns
        ``(predictions, scores, layer NLLs, fitted latents)``."""
        _, m, transform, weighted = CONFIGS[name]
        x, y, w = config_data(n, 4, m, transform, seed)
        xs, ys, ws = config_data(n // 4, 4, m, transform, seed + 1)
        reg.fit(x, y, w if weighted else None, iters=5)
        fitted = reg.vs.snapshot()
        if latents is not None:
            reg.load_latents(latents)
        # The same standard normals on either device (their generators differ).
        normals = np.random.default_rng(seed + 2).standard_normal((2, 4, 50, len(x[::8])))
        out = reg.predict(x[::8], num_samples=50, credible_bounds=True, normals=normals[0],
                          noise_normals=normals[1])
        scores = [reg.logpdf(xs, ys, ws, posterior=post) for post in (False, True)]
        return out, scores, reg.last_fit_report["layer_nll"], fitted

    for name in CONFIGS:
        for model, n_ind in (("sparse", 64), ("dense", 0)):
            reg = build(name, n_ind, device, torch.float32)
            (out, scores, nll, _), wall, _, c = launches_checked(
                f"{name} {model}", lambda: request(reg, name, 2000, 3), backward=True)
            terms = []
            for pi in range(reg.p):
                f, _ = _model_generator(reg.vs, reg.m, pi, **reg.model_config)()
                parsed = GK.analyze_kernel(f.kernel, reg.m + pi)
                terms.append("refused" if parsed is None else "+".join(t.kind for t in parsed[0]))
            ok = all(np.isfinite(a).all() for a in out) and np.isfinite(scores).all() and "refused" not in terms
            res[f"{name} {model}"] = dict(wall_s=wall, launches=c["gram_kernel_launches"],
                                          bwd_launches=c["gram_bwd_kernel_launches"],
                                          gram_eval_calls=c["gram_eval_cuda_calls"], scores=scores)
            print(f"{P} {name} {model} n=2000 p=4 float32: fit_predict + 2 scores {wall:.3f} s; layer NLL "
                  f"{np.round(nll, 3).tolist()}; scores {np.round(scores, 3).tolist()}; analyser terms per "
                  f"layer {terms}; gram launches {c['gram_kernel_launches']}, backward "
                  f"{c['gram_bwd_kernel_launches']}, gram_eval on CUDA {c['gram_eval_cuda_calls']}, "
                  f"plain-route CUDA Grams {c['gram_plain_cuda_calls']}; finite: {ok}")
            if not ok:
                raise AssertionError(f"{name} {model}: non-finite results or a refused tree: {terms}")
        for model, n_ind in (("sparse", 8), ("dense", 0)):
            # Predictions and scores at the CPU's fitted latents: the two
            # fits agree to rounding, which the periodic term's period
            # amplifies in the predictions (to 4e-6 of a small value).
            oh, sh, nh, lh = request(build(name, n_ind, "cpu", torch.float64), name, 96, 5)
            oc, sc, nc, _ = request(build(name, n_ind, "cuda", torch.float64), name, 96, 5, latents=lh)
            np.testing.assert_allclose(nc, nh, rtol=1e-6)
            np.testing.assert_allclose(sc, sh, rtol=1e-6)
            for a, b in zip(oc, oh):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
        print(f"{P} {name} float64 n=96, sparse and dense: the fit's layer NLLs on cuda == on cpu, and "
              f"at the CPU's latents predictions and scores (rtol 1e-6)")
    return res


def timed_calls(tag, fn, reps):
    """``reps`` calls of ``fn`` through :func:`launches_checked` (no backward
    launches): the results, and each call's wall-clock and Gram launches
    (counted from 0 for each call)."""
    outs, walls, launches = [], [], []
    for _ in range(reps):
        out, wall, _, c = launches_checked(tag, fn, backward=False)
        outs.append(out)
        walls.append(wall)
        launches.append(c["gram_kernel_launches"])
    return outs, walls, launches


def same_bits(a, b):
    """Two results of a predict (tuples of arrays) or a score: equal bits."""
    if isinstance(a, tuple):
        return all(np.array_equal(u, v) for u, v in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def cached_against_uncached(P, tag, reg, fn, saved, reps=3):
    """``fn()`` ``reps`` times from the cached posterior factors and
    ``reps`` times with ``config.posterior_cache = False``, each call's
    wall-clock and Gram launches printed: the results must be the same bits
    and every cached call must launch ``saved`` Grams fewer (the
    factorisation's Grams).  One call of each route comes first, untimed: a
    ``replace=True`` predict captures its route's tail CUDA graph there,
    whose warm-up run launches the Grams once more.  Returns the numbers."""
    import gpar_torch

    fn()
    cached = timed_calls(f"{tag} cached", fn, reps)
    gpar_torch.config.posterior_cache = False
    try:
        fn()
        plain = timed_calls(f"{tag} uncached", fn, reps)
    finally:
        gpar_torch.config.posterior_cache = True
    same = all(same_bits(o, cached[0][0]) for o in cached[0] + plain[0])
    print(f"{P} {tag}: cached {[round(w, 4) for w in cached[1]]} s, gram kernel launches "
          f"{cached[2]}; uncached {[round(w, 4) for w in plain[1]]} s, launches {plain[2]}; the same "
          f"bits: {same}")
    if not same:
        raise AssertionError(f"{tag}: cached and uncached results differ")
    if any(c != u - saved for c in cached[2] for u in plain[2]):
        raise AssertionError(f"{tag}: cached launches {cached[2]} are not the uncached {plain[2]} "
                             f"less {saved}")
    return dict(cached_s=cached[1], uncached_s=plain[1], cached_launches=cached[2][0],
                uncached_launches=plain[2][0])


def phase_serve(device, main_res, sparse_reg, replace_false_reg, dense_reg):
    """The serving layer (``[serve]`` lines): the posterior-factor cache,
    ``precompute``, ``warmup``, the checkpoint, tensor inputs and the graph
    cache's byte budget, at the bench model's full width.

    - The sparse ``[main]`` model (``replace=True``) and the ``[ancestral]``
      model (``replace=False``): ``precompute()`` is True; three predicts of
      100 samples at the 1024 test rows from the cached factors and three
      with the cache off, from the same normals: the same bits, 2p Grams
      fewer per cached call (no Kmm, no Kmn); the same for the posterior
      score of the serve's 2000-row dataset.
    - The dense model at n = 2000 (bucket 2432), fitted here: the same with
      p Grams fewer (no K); the dense bench model (11 840 rows): its stack of
      8.37 GiB is over the 1 GiB limit, so ``precompute()`` is False and a
      predict computes no stacked factors.
    - ``warmup(10 000, 16, n_test=1024, iters=10)`` of a fresh estimator
      after ``graphs.clear_cache()``, then a fresh estimator's request on
      the bench data: no capture (``capture_s`` 0), the ``10k`` gates, its
      wall-clock beside ``[main]``'s cold and warm.
    - ``save`` / ``load`` of the ``[main]`` model: the load starts with no
      factors and predicts the same bits.
    - CUDA tensors that require grad through ``condition``, ``predict`` and
      ``logpdf`` (a 0-d CUDA tensor), as the NumPy inputs.
    - The graph cache under a budget just above one dense n = 2000 step's
      measured bytes: two fits that differ only in ``iters`` leave one step
      cached; reserved memory before, between and after them, and after
      ``graphs.clear_cache()``.
    """
    import tempfile

    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.config import bucket_rows
    from gpar_torch.models import fused, graphs
    from gpar_torch.ops import gram_kernel as GK
    from gpar_torch.utils import checkpoint

    P = "[serve]"
    gpar_torch.config.epsilon = 1e-6
    n, p, n_test, num_samples, iters = 10_000, 16, 1024, 100, 10
    x, y, f = make_data(n, p)
    test_idx = np.arange(n)[:: n // n_test][:n_test]
    x_test, f_test = x[test_idx], f[test_idx]
    xs, ys, _ = make_data(2000, p, seed=500)
    gen = torch.Generator(device).manual_seed(7)
    normals = torch.randn((p, num_samples, n_test), generator=gen, device=device)
    res = {"launches": 0}

    def predict(reg):
        return lambda: reg.predict(x_test, num_samples=num_samples, credible_bounds=True,
                                   normals=normals, noise_normals=normals)

    def score(reg, x_, y_):
        return lambda: reg.logpdf(x_, y_, posterior=True)

    def precomputed(tag, reg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = reg.precompute()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"{P} {tag}: precompute() {ok} in {wall:.4f} s")
        return ok, wall

    for tag, reg in (("sparse replace=True", sparse_reg), ("sparse replace=False", replace_false_reg)):
        ok, wall = precomputed(tag, reg)
        if not ok:
            raise AssertionError(f"{tag}: precompute() is False")
        res[tag] = dict(precompute_s=wall, predict=cached_against_uncached(P, f"{tag} predict", reg,
                                                                        predict(reg), 2 * p))
        res["launches"] += res[tag]["predict"]["cached_launches"]
    tag = "sparse posterior logpdf"
    res[tag] = cached_against_uncached(P, tag, sparse_reg, score(sparse_reg, xs, ys), 2 * p)
    res["launches"] += res[tag]["cached_launches"]

    # The dense model at n = 2000: its graphed fit also measures one step's
    # pinned bytes for the graph-cache check below.
    graphs.clear_cache()
    x2, y2, _ = make_data(2000, p, seed=3)
    kw_dense = dict(model_kwargs(x), x_ind=None)
    dense2 = GPARRegressor(**kw_dense, device=device)
    dense2.fit(x2, y2, iters=iters)
    one_step = graphs.cached_bytes()
    ok, wall = precomputed("dense n=2000", dense2)
    if not ok:
        raise AssertionError("dense n=2000: precompute() is False")
    res["dense n=2000"] = dict(
        precompute_s=wall, predict=cached_against_uncached(P, "dense n=2000 predict", dense2,
                                                           predict(dense2), p),
        logpdf=cached_against_uncached(P, "dense n=2000 posterior logpdf", dense2,
                                       score(dense2, xs, ys), p))
    res["launches"] += (res["dense n=2000"]["predict"]["cached_launches"]
                        + res["dense n=2000"]["logpdf"]["cached_launches"])
    del dense2

    # The dense bench model: over the limit, no stack is built.
    stacks = []
    real = fused.make_scan_posterior_factors
    fused.make_scan_posterior_factors = lambda *a, **k: stacks.append(1) or real(*a, **k)
    try:
        ok = dense_reg.precompute()
        _, wall, _, c = launches_checked("dense bench predict", predict(dense_reg), backward=False)
    finally:
        fused.make_scan_posterior_factors = real
    plan = dense_reg._scan_fit_plan(dense_reg.vs.select(None))
    n_b = bucket_rows(plan.n)
    stack_gib = plan.p * n_b * (n_b + plan.W + 1) * 4 / 2**30
    print(f"{P} dense bench (rows {n_b}): stack {stack_gib:.2f} GiB against the limit "
          f"{gpar_torch.config.posterior_cache_max_bytes / 2**30:.2f} GiB; precompute() {ok}; a predict "
          f"{wall:.3f} s, {c['gram_kernel_launches']} Gram launches, stacked factor computations "
          f"{len(stacks)}")
    if ok or stacks or dense_reg._factor_cache is not None:
        raise AssertionError("dense bench: the over-limit stack was cached")
    res["dense bench"] = dict(precompute=ok, stack_gib=stack_gib, predict_s=wall)

    # warmup, then a fresh estimator's first request of the bucket.
    graphs.clear_cache()
    kw = model_kwargs(x)
    t0 = time.perf_counter()
    rep = GPARRegressor(**kw, device=device).warmup(n, p, n_test=n_test, iters=iters)
    warm_s = time.perf_counter() - t0
    print(f"{P} warmup(10 000, 16, n_test=1024, iters=10): {warm_s:.3f} s; buckets {rep['buckets']}; "
          f"seconds by path " + json.dumps({k: round(v, 4) for k, v in rep["seconds"].items()}))
    fresh = GPARRegressor(**kw, device=device)

    def request():
        return fresh.fit_predict(x, y, x_test, iters=iters, num_samples=num_samples,
                                 credible_bounds=True, generator=torch.Generator(device).manual_seed(0))

    out, wall, peak, c = launches_checked("request after warmup", request, backward=True)
    fit_rep = fresh.last_fit_report
    q = check_quality(P, "request after warmup", out, fit_rep, f_test)
    print(f"{P} request after warmup: fit_predict {wall:.3f} s (fit {fit_rep['wall_clock_s']:.3f} s), "
          f"capture {fit_rep['capture_s']:.3f} s; [main] cold {main_res['cold_s']:.3f} s, warm "
          f"{main_res['warm_s']:.3f} s; gram kernel launches {c['gram_kernel_launches']}, backward "
          f"{c['gram_bwd_kernel_launches']}")
    if fit_rep["capture_s"] != 0.0:
        raise AssertionError(f"request after warmup captured graphs ({fit_rep['capture_s']} s)")
    res["warmup"] = dict(warmup_s=warm_s, seconds=rep["seconds"], buckets=rep["buckets"],
                         request_s=wall, fit_s=fit_rep["wall_clock_s"], capture_s=fit_rep["capture_s"],
                         main_cold_s=main_res["cold_s"], main_warm_s=main_res["warm_s"],
                         launches=c["gram_kernel_launches"], bwd_launches=c["gram_bwd_kernel_launches"],
                         peak_gib=peak, **q)
    del fresh

    # Checkpoint of the [main] model.
    want = predict(sparse_reg)()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "main.pkl")
        t0 = time.perf_counter()
        checkpoint.save(sparse_reg, path)
        back = checkpoint.load(path)
        load_s = time.perf_counter() - t0
    empty = back._factor_cache is None
    got = predict(back)()
    same = same_bits(got, want)
    print(f"{P} checkpoint save + load {load_s:.3f} s; the loaded cache empty: {empty}; predicts the "
          f"same bits: {same}")
    if not (empty and same):
        raise AssertionError("checkpoint: the loaded estimator differs")
    res["checkpoint"] = dict(save_load_s=load_s, same_bits=same)

    # CUDA tensors that require grad.
    xt, yt = (torch.tensor(a, device=device, requires_grad=True) for a in (x, y))
    tens = GPARRegressor(**kw, device=device)
    tens.condition(xt, yt)
    tens.load_latents(sparse_reg.vs.snapshot())
    got = tens.predict(torch.tensor(x_test, device=device, requires_grad=True), num_samples=num_samples,
                       credible_bounds=True, normals=normals)
    lp = tens.logpdf(xt, yt, posterior=True)
    ref = GPARRegressor(**kw, device=device)
    ref.condition(x, y)
    ref.load_latents(sparse_reg.vs.snapshot())
    same = same_bits(got, ref.predict(x_test, num_samples=num_samples, credible_bounds=True,
                                      normals=normals))
    ok = (isinstance(lp, torch.Tensor) and lp.ndim == 0 and lp.device.type == torch.device(device).type
          and not lp.requires_grad and float(lp) == ref.logpdf(x, y, posterior=True))
    print(f"{P} CUDA tensors that require grad: predict the same bits as NumPy inputs {same}; logpdf a "
          f"0-d {lp.dtype} tensor on {lp.device}, {float(lp)!r}, equal to the float: {ok}")
    if not (same and ok):
        raise AssertionError("tensor inputs differ from NumPy inputs")
    del tens, ref

    # The graph cache's byte budget: room for one dense n = 2000 step.
    graphs.clear_cache()
    budget = gpar_torch.config.graph_cache_max_bytes
    gpar_torch.config.graph_cache_max_bytes = one_step + one_step // 4
    try:
        reserved = [reserved_bytes()]
        for it in (iters, iters + 1):
            GPARRegressor(**kw_dense, device=device).fit(x2, y2, iters=it)
            reserved.append(reserved_bytes())
        keys = [k[5] for k in graphs._CACHE]
        sizes = [e[2] for e in graphs._CACHE.values()]
    finally:
        gpar_torch.config.graph_cache_max_bytes = budget
    graphs.clear_cache()
    reserved.append(reserved_bytes())
    gib = 2**30
    print(f"{P} graph cache: one dense n=2000 step pins {one_step / gib:.4f} GiB; budget "
          f"{(one_step + one_step // 4) / gib:.4f} GiB; after fits with iters {iters} and {iters + 1} the "
          f"cached keys (iters) {keys}, pinning {[round(s / gib, 4) for s in sizes]} GiB; reserved before, "
          f"after the first fit, after the second and after clear_cache(): "
          f"{[round(r / gib, 4) for r in reserved]} GiB")
    if len(keys) != 1:
        raise AssertionError(f"graph cache: {len(keys)} steps cached under a one-step budget")
    res["graph cache"] = dict(one_step_gib=one_step / gib, keys=keys, pinned_gib=[s / gib for s in sizes],
                              reserved_gib=[r / gib for r in reserved])
    return res


def rel_diff(a, b):
    """max |a - b| / max |b| over arrays (or tuples of them)."""
    if isinstance(a, tuple):
        return max(rel_diff(u, v) for u, v in zip(a, b))
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


#: The float64 unrolled routes against the scan routes (``[unroll]``).
UNROLL_TOL_F64 = 1e-8


def phase_unroll(device):
    """The unrolled oracle at full width (``[unroll]`` lines): the JAX
    package's ``fit(fused="unroll")`` and its serving routes under
    ``config.scan_predict = False``, both eager through ``GPAR.logpdf`` and
    ``GPAR.sample_batch`` on the GP core, the Gram kernel pair beneath.

    - The bench's sparse model (n = 10 000, p = 16, 256 inducing points, 10
      iterations, float32): the graphed scan fit from phase 3's initial
      latents, then ``fit(fused="unroll")`` from the same latents twice
      (cold and warm: the same bits), their wall-clock, L-BFGS host reads
      and launches, the sum of layer NLLs beside the scan's.  From the
      scan-fitted latents ``predict`` (100 samples at the 1024 test rows,
      ``replace=True``) and posterior ``sample`` on both routes, from the
      normals the scan tail drew in phase 3: max |d| of the draws and of
      the mean, and the ``10k`` gates on the unrolled predict.
    - The dense model at n = 2000 (p = 16; its eager fit at 10 000 rows
      takes tens of seconds): the same fits and predict, printed.
    - float64 at n = 2000, p = 4, sparse (64 inducing points) and dense:
      the unrolled fit against the scan fit from the same latents (layer
      NLLs), ``predict``, ``sample`` and the posterior ``logpdf`` against
      the scan routes, each to :data:`UNROLL_TOL_F64` relative.
    """
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor

    P = "[unroll]"
    cfg = gpar_torch.config
    cfg.epsilon = 1e-6
    res, prev = {}, cfg.scan_predict

    def unrolled(fn):
        """``fn()`` with ``config.scan_predict`` off, restored whatever
        happens."""
        cfg.scan_predict = False
        try:
            return fn()
        finally:
            cfg.scan_predict = prev

    for model, n, n_test in (("sparse", 10_000, 1024), ("dense", 2000, 200)):
        x, y, f = make_data(n, 16)
        test_idx = np.arange(n)[:: n // n_test][:n_test]
        x_test, f_test = x[test_idx], f[test_idx]
        kw = model_kwargs(x)
        if model == "dense":
            kw["x_ind"] = None
        reg = GPARRegressor(**kw, device=device)
        reg.condition(x, y)
        reg._ensure_vars(reg.p)
        z_init = reg.vs.snapshot()
        reg.fit(x, y, iters=10)
        scan_rep, z_scan = reg.last_fit_report, reg.vs.snapshot()
        fits = []
        for tag in ("cold", "warm"):
            reg.vs.restore(z_init)
            _, wall, peak, c = launches_checked(f"{model} unroll fit {tag}",
                                                lambda: reg.fit(x, y, iters=10, fused="unroll"),
                                                backward=True)
            rep = reg.last_fit_report
            fits.append((rep, reg.vs.snapshot(), wall, c))
            print(f"{P} {model} n={n} p=16 float32: fit(fused='unroll', iters=10) {tag} {wall:.3f} s; "
                  f"peak device memory {peak:.2f} GiB; L-BFGS host reads {rep['host_syncs']} "
                  f"(iterations {int(np.sum(rep['layer_iters']))}, backtracking trials "
                  f"{rep['linesearch_trials']}); gram kernel launches {c['gram_kernel_launches']}, "
                  f"backward launches {c['gram_bwd_kernel_launches']} for {c['gram_autograd_calls']} "
                  f"Grams under autograd; sum of layer NLLs {float(np.sum(rep['layer_nll'])):.3f} "
                  f"against the graphed scan fit's {float(np.sum(scan_rep['layer_nll'])):.3f} "
                  f"({scan_rep['wall_clock_s']:.3f} s)")
            if rep["fused"] != "unroll" or rep["graph_replays"]:
                raise AssertionError(f"{model}: fused='unroll' did not run the unrolled fit: {rep}")
        (cold, z_cold, cold_s, cold_c), (warm, z_warm, warm_s, _) = fits
        same = (np.array_equal(cold["layer_nll"], warm["layer_nll"])
                and all(np.array_equal(z_cold[k], z_warm[k]) for k in z_cold))
        print(f"{P} {model}: cold and warm unrolled fits identical: {same}")
        if not same:
            raise AssertionError(f"{model}: the unrolled fit is not deterministic")
        # From the scan-fitted latents, the normals the scan tail drew in
        # phase 3 (a generator seeded 0, nothing drawn before them).
        reg.load_latents(z_scan)
        normals = torch.randn((16, 100, n_test), generator=torch.Generator(device).manual_seed(0),
                              dtype=reg.dtype, device=device)
        scan_pred = reg.predict(x_test, num_samples=100, credible_bounds=True, normals=normals)
        pred, pred_s, _, pc = launches_checked(f"{model} unrolled predict", lambda: unrolled(
            lambda: reg.predict(x_test, num_samples=100, credible_bounds=True, normals=normals)),
            backward=False)
        draws, sample_s, _, _ = launches_checked(f"{model} unrolled sample", lambda: unrolled(
            lambda: np.stack(reg.sample(x_test, posterior=True, num_samples=100, normals=normals))),
            backward=False)
        scan_draws = np.stack(reg.sample(x_test, posterior=True, num_samples=100, normals=normals))
        d_draw = float(np.max(np.abs(draws - scan_draws)))
        d_mean = float(np.max(np.abs(pred[0] - scan_pred[0])))
        q = check_quality(P, f"{model} unrolled predict", pred, scan_rep, f_test, gates=model == "sparse")
        print(f"{P} {model}: unrolled predict (100 samples, {n_test} test rows) {pred_s:.3f} s, "
              f"sample {sample_s:.3f} s; gram kernel launches {pc['gram_kernel_launches']}; against "
              f"the scan tail from the same normals: max |d draw| {d_draw:.3e} (of max |draw| "
              f"{float(np.max(np.abs(scan_draws))):.3e}), max |d mean| {d_mean:.3e}")
        res[model] = dict(
            n=n, fit_cold_s=cold_s, fit_warm_s=warm_s, scan_fit_s=scan_rep["wall_clock_s"],
            host_syncs=cold["host_syncs"], linesearch_trials=cold["linesearch_trials"],
            nll_sum=float(np.sum(cold["layer_nll"])), scan_nll_sum=float(np.sum(scan_rep["layer_nll"])),
            launches=cold_c["gram_kernel_launches"] + pc["gram_kernel_launches"],
            bwd_launches=cold_c["gram_bwd_kernel_launches"], predict_s=pred_s, sample_s=sample_s,
            max_abs_d_draw=d_draw, max_abs_d_mean=d_mean, mean_smse=q["mean_smse"],
            worst_smse=q["worst_smse"])

    x, y, _ = make_data(2000, 4, seed=3)
    x, y = x.astype(np.float64), y.astype(np.float64)
    xs, ys, _ = make_data(500, 4, seed=8)
    x_test = np.linspace(0.1, 9.9, 200)
    normals = np.random.default_rng(6).standard_normal((4, 50, len(x_test)))
    for model in ("sparse", "dense"):
        kw = model_kwargs(x, n_ind=64)
        if model == "dense":
            kw["x_ind"] = None
        runs = {}
        for fused in (True, "unroll"):
            reg = GPARRegressor(**kw, device=device, dtype=torch.float64)
            reg.fit(x, y, iters=10, fused=fused)
            runs[fused] = reg
        scan, unroll = runs[True], runs["unroll"]
        gaps = {"layer NLL": rel_diff(unroll.last_fit_report["layer_nll"], scan.last_fit_report["layer_nll"])}
        for what, call in (
            ("predict", lambda: scan.predict(x_test, num_samples=50, credible_bounds=True, normals=normals)),
            ("sample", lambda: np.stack(scan.sample(x_test, posterior=True, num_samples=50,
                                                    normals=normals))),
            ("posterior logpdf", lambda: scan.logpdf(xs.astype(np.float64), ys.astype(np.float64),
                                                     posterior=True)),
        ):
            gaps[what] = rel_diff(unrolled(call), call())
        print(f"{P} float64 {model} n=2000 p=4: unrolled routes against the scan routes, relative "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()) + f" (limit {UNROLL_TOL_F64:g})")
        if max(gaps.values()) > UNROLL_TOL_F64:
            raise AssertionError(f"float64 {model}: the unrolled routes differ from the scan routes: {gaps}")
        res[f"float64 {model}"] = gaps
    return res


#: The float64 traced fit on the card against the same fit on the CPU
#: (``[trace]``), the bound of the other float64 route checks.
TRACE_TOL_F64 = 1e-8
_LBFGS_LINE = r"lbfgs iter (\d+): objective (\S+)"


def traced(fn):
    """``fn()`` with its standard output captured; returns ``(out, the
    objectives of its lbfgs iter lines)``."""
    import contextlib
    import io
    import re

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, [float(v) for _, v in re.findall(_LBFGS_LINE, buf.getvalue())]


def check_trace_lines(tag, objectives, rep):
    """One finite objective printed per L-BFGS iteration of the report; one
    host read per iteration and per line-search step, one evaluation per
    step and one at each layer's start."""
    want = int(np.sum(rep["layer_iters"]))
    if len(objectives) != want or not np.all(np.isfinite(objectives)):
        raise AssertionError(f"{tag}: {len(objectives)} lbfgs iter lines for {want} iterations, "
                             f"finite: {bool(np.all(np.isfinite(objectives)))}")
    if not rep["trace"] or rep["fused"] is not False:
        raise AssertionError(f"{tag}: the fit did not run the traced per-layer driver: {rep}")
    steps = rep["linesearch_trials"]
    if rep["host_syncs"] != want + steps or rep["evaluations"] != len(rep["layer_iters"]) + steps:
        raise AssertionError(f"{tag}: host reads {rep['host_syncs']} and evaluations "
                             f"{rep['evaluations']} for {want} iterations and {steps} line-search "
                             "steps (one read per iteration and per step, one evaluation per step "
                             "and one per layer)")


def profile_kernel_events(profile_dir):
    """The one ``*.pt.trace.json`` in ``profile_dir``: its device kernel
    events counted by the Gram kernels' names, and every kernel event."""
    import glob

    files = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{profile_dir}: {len(files)} *.pt.trace.json files, expected 1")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels)
             for k in ("gram_tile_kernel", "gram_bwd_kernel", "gram_bwd_reduce")}
    return found, len(kernels), os.path.getsize(files[0])


def phase_trace(device):
    """The traced and profiled fit at full width (``[trace]`` lines):
    ``fit(trace=True)`` runs the per-layer driver with optax's zoom-line-
    search L-BFGS (``gpar_torch/params/zoom.py``), printing one ``lbfgs
    iter`` line per iteration; ``fit(profile_dir=)`` runs under
    ``torch.profiler`` and writes ``*.pt.trace.json``.

    - The bench's sparse request (n = 10 000, p = 16, 256 inducing points,
      10 iterations per layer, 100 samples at 1024 test points, float32)
      through ``fit_predict(..., trace=True)``: its lines counted (one per
      iteration, each finite), the ``10k`` gates on its predict, wall-clock,
      evaluations, host reads, launches and peak memory.
    - The dense model at n = 2000, 10 iterations, traced.
    - float64 at n = 2000, p = 4 (64 inducing points): the traced fit on
      the card against the same traced fit on the CPU, layer NLLs within
      :data:`TRACE_TOL_F64` relative.
    - ``fit(profile_dir=tmp, iters=3)`` of the bench's model at n = 2000,
      p = 4 (the trace records every operator the host dispatches): one
      traced fit and one cold default fit (the graph cache cleared, so its
      step is captured under the profiler); each trace must hold device
      events of ``gram_tile_kernel`` and ``gram_bwd_kernel``.
    """
    import tempfile

    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.models import graphs

    P = "[trace]"
    gpar_torch.config.epsilon = 1e-6
    res = {}

    def line(tag, rep, wall, peak, c, n_lines):
        print(f"{P} {tag}: {wall:.3f} s (fit {rep['wall_clock_s']:.3f} s); {n_lines} lbfgs iter lines "
              f"for {int(np.sum(rep['layer_iters']))} iterations; objective evaluations "
              f"{rep['evaluations']}; line-search steps {rep['linesearch_trials']}; L-BFGS host reads "
              f"{rep['host_syncs']}; gram kernel launches {c['gram_kernel_launches']}, backward "
              f"launches {c['gram_bwd_kernel_launches']} for {c['gram_autograd_calls']} Grams under "
              f"autograd; plain-route CUDA Grams {c['gram_plain_cuda_calls']}, gram_eval on CUDA "
              f"{c['gram_eval_cuda_calls']}; peak device memory {peak:.2f} GiB; sum of layer NLLs "
              f"{float(np.sum(rep['layer_nll'])):.3f}")
        return dict(wall_s=wall, fit_s=rep["wall_clock_s"], lines=n_lines,
                    iterations=int(np.sum(rep["layer_iters"])), evaluations=rep["evaluations"],
                    linesearch_steps=rep["linesearch_trials"], host_syncs=rep["host_syncs"],
                    launches=c["gram_kernel_launches"], bwd_launches=c["gram_bwd_kernel_launches"],
                    peak_gib=peak, nll_sum=float(np.sum(rep["layer_nll"])))

    # The bench's sparse request, traced.
    n, n_test = 10_000, 1024
    x, y, f = make_data(n, 16)
    test_idx = np.arange(n)[:: n // n_test][:n_test]
    reg = GPARRegressor(**model_kwargs(x), device=device)
    gen = torch.Generator(device).manual_seed(0)
    (out, objectives), wall, peak, c = launches_checked("sparse traced fit_predict", lambda: traced(
        lambda: reg.fit_predict(x, y, x[test_idx], num_samples=100, credible_bounds=True, iters=10,
                                trace=True, generator=gen)), backward=True)
    rep = reg.last_fit_report
    check_trace_lines("sparse", objectives, rep)
    res["sparse"] = line("sparse n=10000 p=16 fit_predict(trace=True, iters=10)", rep, wall, peak, c,
                         len(objectives))
    res["sparse"].update(check_quality(P, "sparse traced predict", out, rep, f[test_idx]))

    # The dense model at n = 2000, traced.
    x, y, _ = make_data(2000, 16)
    kw = dict(model_kwargs(x), x_ind=None)
    reg = GPARRegressor(**kw, device=device)
    (_, objectives), wall, peak, c = launches_checked("dense traced fit", lambda: traced(
        lambda: reg.fit(x, y, iters=10, trace=True)), backward=True)
    rep = reg.last_fit_report
    check_trace_lines("dense", objectives, rep)
    res["dense"] = line("dense n=2000 p=16 fit(trace=True, iters=10)", rep, wall, peak, c,
                        len(objectives))

    # float64: the card against the CPU.
    x, y, _ = make_data(2000, 4, seed=3)
    x, y = x.astype(np.float64), y.astype(np.float64)
    fits = {}
    for dev in ("cuda", "cpu"):
        r = GPARRegressor(**model_kwargs(x, n_ind=64), device=dev, dtype=torch.float64)
        t0 = time.perf_counter()
        _, objectives = traced(lambda: r.fit(x, y, iters=10, trace=True))
        check_trace_lines(f"float64 {dev}", objectives, r.last_fit_report)
        fits[dev] = (r.last_fit_report, objectives, time.perf_counter() - t0)
    gap = rel_diff(fits["cuda"][0]["layer_nll"], fits["cpu"][0]["layer_nll"])
    print(f"{P} float64 sparse n=2000 p=4: traced fit on the card {fits['cuda'][2]:.3f} s, on the CPU "
          f"{fits['cpu'][2]:.3f} s; layer NLLs relative {gap:.3e} (limit {TRACE_TOL_F64:g}); the same "
          f"number of lbfgs iter lines: {len(fits['cuda'][1]) == len(fits['cpu'][1])}")
    if gap > TRACE_TOL_F64:
        raise AssertionError(f"float64 traced fit: card against CPU {gap:.3e}")
    res["float64"] = dict(rel_layer_nll=gap, card_s=fits["cuda"][2], cpu_s=fits["cpu"][2])

    # Profiled fits: their traces must name both kernels.  Small (p = 4, 3
    # iterations): the trace records every operator the host dispatches.
    x, y, _ = make_data(2000, 4)
    for tag, kw in (("traced", dict(trace=True)), ("default cold", {})):
        if not kw:
            graphs.clear_cache()  # the step is captured inside the profiled window
        reg = GPARRegressor(**model_kwargs(x), device=device)
        with tempfile.TemporaryDirectory() as d:
            (_, objectives), wall, peak, c = launches_checked(f"profiled {tag} fit", lambda: traced(
                lambda: reg.fit(x, y, iters=3, profile_dir=d, **kw)), backward=True)
            found, n_kernels, size = profile_kernel_events(d)
        rep = reg.last_fit_report
        print(f"{P} fit(profile_dir=, {tag}, iters=3) sparse n=2000 p=4: {wall:.3f} s; route "
              f"fused={rep['fused']}, cuda_graphs={rep['cuda_graphs']}, graph replays "
              f"{rep['graph_replays']}; trace file {size / 2**20:.1f} MiB, {n_kernels} device kernel "
              f"events, by name {found}; launches counted {c['gram_kernel_launches']} forward, "
              f"{c['gram_bwd_kernel_launches']} backward")
        if not (found["gram_tile_kernel"] > 0 and found["gram_bwd_kernel"] > 0):
            raise AssertionError(f"profiled {tag} fit: its trace lacks the Gram kernels: {found}")
        if tag == "traced":
            check_trace_lines("profiled traced", objectives, rep)
        elif not rep["cuda_graphs"] or rep["graph_replays"] <= 0 or rep["capture_s"] <= 0:
            raise AssertionError(f"profiled default fit: no graphs captured and replayed: {rep}")
        res[f"profiled {tag}"] = dict(wall_s=wall, cuda_graphs=rep["cuda_graphs"],
                                      kernel_events=n_kernels, by_name=found, trace_mib=size / 2**20,
                                      launches=c["gram_kernel_launches"],
                                      bwd_launches=c["gram_bwd_kernel_launches"])
    return res


#: The examples' workloads (``examples/*.py``): the loader's call, the
#: script's constructor arguments verbatim, its fit and predict keywords, its
#: metric with the ``check_metric`` name and bound, its jitter, and the
#: (iterations, samples) of ``--quick`` and of a full run.
def example_specs():
    from gpar_torch import log_transform
    from gpar_torch.utils import data, metrics

    def eeg():
        x, y_train, y_test, _ = data.load_eeg()
        return x, y_train, [(x, y_test)]

    def exchange():
        x, y_train, y_test, _ = data.load_exchange()
        return x, y_train, [(x, y_test)]

    def jura():
        x_train, y_train, x_test, y_test, _ = data.load_jura()
        return x_train, y_train, [(x_test, y_test)]

    def air_temp(size):
        def load():
            _, x_train, y_train, tests = data.load_air_temp(size=size)
            return x_train, y_train, tests
        return load

    def air_ind(size):
        x_all = data.load_air_temp(size=size)[0]
        return np.linspace(x_all.min(), x_all.max(), [10 * 10 + 1, 10 * 15 + 1, 10 * 31 + 1][size])

    def chunk_smse(preds, tests, y_train):
        return float(np.nanmean([np.nanmean(metrics.smse(p, y)) for p, (_, y) in zip(preds, tests)]))

    def exchange_smse(preds, tests, y_train):
        return float(np.nanmean(metrics.smse_train_mean(preds[0], tests[0][1], np.nanmean(y_train, axis=0))))

    def jura_mae(preds, tests, y_train):
        return float(metrics.mae(preds[0], tests[0][1])[2])  # Cd

    specs = {
        "eeg": dict(load=eeg, kw=dict(scale=0.02, linear=False, nonlinear=True, nonlinear_scale=1.0,
                                      noise=0.01, impute=True, replace=False, normalise_y=True,
                                      compat=True),
                    fit={}, predict=dict(credible_bounds=True, latent=True), metric=chunk_smse,
                    title="eeg mean SMSE", bound=0.30, epsilon=1e-12, quick=(20, 50), full=(200, 200)),
        "exchange": dict(load=exchange, kw=dict(scale=0.1, linear=True, linear_scale=10.0, nonlinear=True,
                                                nonlinear_scale=1.0, rq=True, noise=0.01, impute=True,
                                                replace=False, normalise_y=True),
                         fit={}, predict=dict(credible_bounds=True, latent=False), metric=exchange_smse,
                         title="exchange mean SMSE", bound=0.15, epsilon=1e-12, quick=(20, 50),
                         full=(200, 200)),
        "jura": dict(load=jura, kw=dict(scale=10.0, linear=False, nonlinear=True, nonlinear_scale=1.0,
                                        noise=0.1, impute=True, replace=True, normalise_y=True,
                                        transform_y=log_transform),
                     fit=dict(fix=False), predict=dict(latent=True), metric=jura_mae, title="jura Cd MAE",
                     bound=0.3, epsilon=1e-12, quick=(10, 50), full=(100, 200)),
    }
    for size in (0, 2):
        specs[f"air_temp{size}"] = dict(
            load=air_temp(size), kw=dict(scale=0.2, linear=True, linear_scale=10.0, nonlinear=True,
                                         nonlinear_scale=1.0, noise=0.1, impute=True, replace=True,
                                         normalise_y=True, x_ind=air_ind(size)),
            fit={}, predict=dict(credible_bounds=True, latent=False), metric=chunk_smse,
            title=f"air_temp mean SMSE (size {size})", bound=0.15, epsilon=1e-6, quick=(10, 20),
            full=(100, 50))
    return specs


def run_example(spec, device, iters, num_samples):
    """One example's workload in float64 on ``device``: load, fit,
    predict every test chunk; returns ``(metric, (rows, p), fit report)``."""
    import torch

    from gpar_torch import GPARRegressor

    x, y_train, tests = spec["load"]()
    model = GPARRegressor(**spec["kw"], device=device, dtype=torch.float64)
    model.fit(x, y_train, iters=iters, **spec["fit"])
    gen = torch.Generator(device).manual_seed(0)
    preds = []
    for x_t, _ in tests:
        out = model.predict(x_t, num_samples=num_samples, generator=gen, **spec["predict"])
        preds.append(out[0] if isinstance(out, tuple) else out)
    if not all(np.isfinite(p).all() for p in preds):
        raise AssertionError("non-finite predictions")
    return spec["metric"](preds, tests, y_train), y_train.shape, model.last_fit_report


def phase_examples(device):
    """The examples' own workloads on the card (``[examples]`` lines): eeg
    (n = 256, p = 7), exchange (251, 13), jura (359, 3, ``fit(fix=False)``,
    ``log_transform``) and air_temp at sizes 0 (1440 rows, 101 inducing
    points) and 2 (4464 rows, 311), on the loaders' seeded synthetic
    stand-ins (``gpar_torch.utils.data``), each with its script's
    constructor arguments, in float64, through the default routes (the
    graphed scan fit, the joint fit for jura).  At the ``--quick`` counts
    each metric goes through ``check_metric`` against the script's bound
    (a ``SystemExit`` fails the run), every Gram through the kernels; at
    the full counts each is timed and its metric printed.  ``config.epsilon``
    is each script's (1e-6 for air_temp) and restored after."""
    import gpar_torch
    from gpar_torch.utils.experiment import check_metric

    P = "[examples]"
    cfg = gpar_torch.config
    prev, res = cfg.epsilon, {}
    try:
        for name, spec in example_specs().items():
            title, bound, quick, full = spec["title"], spec["bound"], spec["quick"], spec["full"]
            cfg.epsilon = spec["epsilon"]
            (value, shape, rep), wall, peak, c = launches_checked(
                f"{name} --quick", lambda: run_example(spec, device, *quick), backward=True)
            print(f"{P} {name} n={shape[0]} p={shape[1]} float64 --quick (iters {quick[0]}, samples "
                  f"{quick[1]}): fit + predict {wall:.3f} s (fit {rep['wall_clock_s']:.3f} s); peak device "
                  f"memory {peak:.2f} GiB; gram kernel launches {c['gram_kernel_launches']} (with a sample "
                  f"axis {c['gram_batched_kernel_launches']}), backward {c['gram_bwd_kernel_launches']}")
            check_metric(title, value, bound)
            t0 = time.perf_counter()
            value_full, _, rep_full = run_example(spec, device, *full)
            wall_full = time.perf_counter() - t0
            print(f"{P} {name} full (iters {full[0]}, samples {full[1]}): {title} {value_full:.6g}; fit + "
                  f"predict {wall_full:.3f} s (fit {rep_full['wall_clock_s']:.3f} s)")
            res[name] = dict(n=shape[0], p=shape[1], quick_metric=value, bound=bound, quick_s=wall,
                             full_metric=value_full, full_s=wall_full,
                             launches=c["gram_kernel_launches"],
                             batched_launches=c["gram_batched_kernel_launches"],
                             bwd_launches=c["gram_bwd_kernel_launches"])
    finally:
        cfg.epsilon = prev
    return res


def phase_profile(state, out_dir, tag="main"):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpar_torch.ops import gram_kernel as GK

    reg, x, y, x_test, z_init = state
    reg.vs.restore(z_init)
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    GK.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reg.fit_predict(x, y, x_test, iters=10, num_samples=100, credible_bounds=True, generator=gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    counts = GK.counters()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
    with open(os.path.join(out_dir, f"profile_table_{tag}.txt"), "w") as fh:
        fh.write(table)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3

    def kernel_ms(*names):
        sel = [e for e in events if any(k in e.name for k in names)]
        return sum(e.device_time for e in sel) / 1e3, len(sel)

    # Device time by kind of kernel (the first kind whose key is in the name).
    kinds = {"potrf": ("getrf", "potrf", "trf4_set_info"), "trsm/trsv": ("trsm", "trsv"),
             "gemm/gemv": ("gemm", "gemv", "splitKreduce"), "syrk": ("syrk",),
             "gram": ("gram_tile_kernel", "gram_bwd")}
    by_kind = {k: [0.0, 0] for k in [*kinds, "other"]}
    for e in events:
        k = next((k for k, keys in kinds.items() if any(s in e.name for s in keys)), "other")
        by_kind[k][0] += e.device_time / 1e3
        by_kind[k][1] += 1
    print(f"[profile {tag}] device time by kind: " + ", ".join(
        f"{k} {t:.1f} ms ({c} kernels)" for k, (t, c) in by_kind.items()))
    fwd, n_fwd = kernel_ms("gram_tile_kernel")
    bwd, n_bwd = kernel_ms("gram_bwd_kernel")
    red, n_red = kernel_ms("gram_bwd_reduce")
    rep = reg.last_fit_report
    print(f"[profile {tag}] warm graphed fit_predict under the profiler: wall {wall_ms:.1f} ms (fit "
          f"{1e3 * rep['wall_clock_s']:.1f} ms), device kernel time {busy:.1f} ms over {len(events)} "
          f"kernels (busy {100 * busy / wall_ms:.1f}%), of which gram kernel {fwd:.2f} ms ({n_fwd} "
          f"launches), gram backward kernel {bwd:.2f} ms ({n_bwd}) and its reduction {red:.2f} ms "
          f"({n_red}); graph replays {rep['graph_replays']}, host reads {rep['host_syncs']}; table in {out_dir}")
    # The counters' totals (each graph replay adds what its capture
    # launched) against the profiler's kernel events, which CUPTI records
    # inside graph replays too.
    total = (counts["gram_kernel_launches"], counts["gram_bwd_kernel_launches"])
    seen = (n_fwd, n_bwd)
    print(f"[profile {tag}] launch counters of that run, replays included: gram kernel {total[0]}, "
          f"backward {total[1]}; profiler's kernel events: gram_tile_kernel {n_fwd}, gram_bwd_kernel "
          f"{n_bwd}: {'agree' if seen == total else 'DIFFER'}")
    if seen != total:
        raise AssertionError("the launch counters disagree with the profiler's kernel events")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import gpar_torch  # noqa: F401 — fails outside a checkout of the repo
    from gpar_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card}; torch {torch.__version__} (CUDA {torch.version.cuda})")
    info = _build.build()
    print(f"[build] {info['path']} (nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    phase_s = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall-clock kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out

    rows, worst = timed("kernel", phase_kernel_check, "cuda")
    rows["gram_batched"], worst["gram_batched"] = timed("kernel batched", phase_batched_kernel_check, "cuda")
    pb_rows, pb_worst = timed("kernel param-batched", phase_param_batched_kernel_check, "cuda")
    rows["gram_param_batched"], worst["gram_param_batched"] = pb_rows["gram"], pb_worst["gram"]
    rows["gram_bwd_batched"], worst["gram_bwd_batched"] = pb_rows["gram_bwd"], pb_worst["gram_bwd"]
    if "--kernels-only" in argv:
        print("[kernel] " + json.dumps(rows))
        return 0
    main_res, state = timed("main", phase_main_path, "cuda")
    dense_res, dense_state = timed("dense", phase_main_path, "cuda", True)
    dense_res["evaluation"] = timed("dense evaluation", phase_dense_evaluation, dense_state[0], "cuda")
    anc_res, anc_reg = timed("ancestral", phase_ancestral, "cuda", state[0])
    logpdf_res = timed("logpdf", phase_logpdf, "cuda", state[0], dense_state[0])
    free_res = timed("free", phase_free, "cuda")
    restarts_res = timed("restarts", phase_restarts, "cuda", main_res, dense_res, free_res)
    batched_res = timed("batched", phase_batched_fit, "cuda", dense_res)
    greedy_res = timed("greedy", phase_greedy, "cuda")
    configs_res = timed("configs", phase_configs, "cuda")
    serve_res = timed("serve", phase_serve, "cuda", main_res, state[0], anc_reg, dense_state[0])
    unroll_res = timed("unroll", phase_unroll, "cuda")
    examples_res = timed("examples", phase_examples, "cuda")
    mesh_res = timed("mesh", phase_mesh, "cuda", main_res)
    trace_res = timed("trace", phase_trace, "cuda")
    timed("small", phase_small_agreement)
    timed("small greedy", phase_small_greedy)
    if "--profile" in argv:
        out_dir = argv[argv.index("--profile") + 1]
        phase_profile(state, out_dir, "main")
        phase_profile(dense_state, out_dir, "dense")

    sources = {
        "gram": ("gpar_torch/csrc/gram.cu", "gpar_tpu/ops/pallas_gram.py:167", "launches",
                 "kernel == plain at f32 rtol/atol 1e-5 and f64 1e-12"),
        "gram_bwd": ("gpar_torch/csrc/gram.cu", "gpar_tpu/ops/pallas_gram.py:289",
                     "bwd_launches",
                     "max|err|/max|plain| <= 1e-4 at f32 and 1e-10 at f64; fused-Gram gradient "
                     "within 1e-5 (f32) / 1e-10 (f64) of the float64 recursion's"),
    }
    unroll_runs = [unroll_res["sparse"], unroll_res["dense"]]
    by_path = {"gram": {"logpdf": logpdf_res["launches"], "free": free_res["sparse"]["launches"],
                        "configs": sum(r["launches"] for r in configs_res.values()),
                        "serve": serve_res["launches"], "warmup": serve_res["warmup"]["launches"],
                        "unroll": sum(r["launches"] for r in unroll_runs),
                        "examples": sum(r["launches"] for r in examples_res.values()),
                        "mesh": mesh_res["sparse"]["launches"] + mesh_res["dense"]["mesh"]["launches"],
                        "trace": trace_res["sparse"]["launches"] + trace_res["dense"]["launches"]},
               "gram_bwd": {"free": free_res["sparse"]["bwd_launches"],
                            "configs": sum(r["bwd_launches"] for r in configs_res.values()),
                            "warmup": serve_res["warmup"]["bwd_launches"],
                            "unroll": sum(r["bwd_launches"] for r in unroll_runs),
                            "examples": sum(r["bwd_launches"] for r in examples_res.values()),
                            "mesh": (mesh_res["sparse"]["bwd_launches"]
                                     + mesh_res["dense"]["mesh"]["bwd_launches"]),
                            "trace": trace_res["sparse"]["bwd_launches"] + trace_res["dense"]["bwd_launches"]}}
    kernels = {"kernels": []}
    for name, (source, replaces, count, check) in sources.items():
        big = next(r for r in rows[name] if r["tree"] == "gated" and (r["n"], r["m"]) == SCAN_SHAPES[0])
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # The sparse and the dense main paths' graphed cold runs, the
            # scan-route scores' cold runs (forward only), the sparse
            # full-width free fit, the configurations, the [serve] phase's
            # first cached predicts and scores (forward only) and its
            # request after warmup, the [unroll] phase's cold unrolled fits
            # and unrolled predicts (sparse at full width, dense at
            # n = 2000), the [examples] phase's --quick runs, the [mesh]
            # phase's sparse cold request and dense n = 2000 request on the
            # 4-shard virtual mesh and the [trace] phase's traced sparse
            # request and dense n = 2000 fit, each counted from 0.
            "launches": main_res[count] + dense_res[count] + sum(by_path[name].values()),
            "launches_by_path": {"sparse": main_res[count], "dense": dense_res[count], **by_path[name]},
            "check": check,
            "max_abs_err": worst[name][torch.float32],
            "ms": big["ms"],
            "kernel_ms": big["ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"],
            "library_ms": None,
            "shape": [big["n"], big["m"], big["d"]],
            "dtype": "float32",
            "per_shape": rows[name],
            "mesh_shard_shapes": [r for r in rows[name]
                                  if r["tree"] == "gated" and (r["n"], r["m"]) in MESH_SHAPES],
        })
    # The Gram with a sample axis: the same kernel, launched once for S Grams
    # by the per-sample tails; its launches from the [ancestral] phase's
    # sparse cold request and its dense request and the [examples] phase's
    # --quick runs (eeg and exchange predict with replace=False), each
    # counted from 0.
    big = rows["gram_batched"][0]
    anc = {"sparse": anc_res["sparse cold"]["batched_launches"], "dense": anc_res["dense"]["batched_launches"],
           "examples": sum(r["batched_launches"] for r in examples_res.values())}
    kernels["kernels"].append({
        "name": "gram_batched",
        "route": "cuda",
        "source": "gpar_torch/csrc/gram.cu",
        "replaces": "gpar_tpu/ops/pallas_gram.py:215",
        "launches": sum(anc.values()),
        "launches_by_path": anc,
        "check": "kernel == plain at f32 rtol/atol 1e-5 and f64 1e-12 at every batched shape",
        "max_abs_err": worst["gram_batched"][torch.float32],
        "ms": big["ms"],
        "kernel_ms": big["ms"],
        "separate_ms": big["separate_ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "shape": [big["S"], big["n"], big["m"], big["d"]],
        "dtype": "float32",
        "per_shape": rows["gram_batched"],
    })
    print("[main] " + json.dumps(main_res))
    print("[dense] " + json.dumps(dense_res))
    print("[ancestral] " + json.dumps(anc_res))
    print("[logpdf] " + json.dumps(logpdf_res))
    # Both kernels over a batch of per-element trees: the restarts',
    # fused="batched"'s and the greedy scorer's route; launches from the
    # [restarts] phase's sparse graphed cold run, its joint fit and its dense
    # run, the [batched] phase's 10-iteration batched fit and the [greedy]
    # phase's sparse cold and dense searches, each counted from 0.
    batched_paths = {
        "restarts sparse": restarts_res["graphed cold"], "restarts joint": restarts_res["joint"],
        "restarts dense": restarts_res["dense"], "fused=batched": batched_res["iters10"]["batched"],
        "greedy sparse": greedy_res["sparse cold"], "greedy dense": greedy_res["dense"],
    }
    for name, count, replaces, check in (
        ("gram_param_batched", "batched_launches", "gpar_tpu/ops/pallas_gram.py:215",
         "kernel == plain at f32 rtol/atol 1e-5 and f64 1e-12, every element; two launches equal"),
        ("gram_bwd_batched", "bwd_batched_launches", "gpar_tpu/ops/pallas_gram.py:289",
         "max|err|/max|plain| <= 1e-4 at f32 and 1e-10 at f64, every element; two launches equal"),
    ):
        big = rows[name][0]  # Kmn of 4 restarts
        by_path = {k: v[count] for k, v in batched_paths.items()}
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "gpar_torch/csrc/gram.cu",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "check": check,
            "max_abs_err": worst[name][torch.float32],
            "ms": big["ms"],
            "kernel_ms": big["ms"],
            "separate_ms": big["separate_ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"],
            "library_ms": None,
            "shape": [big["B"], big["n"], big["m"], big["d"]],
            "dtype": "float32",
            "per_shape": rows[name],
        })
    print("[free] " + json.dumps(free_res))
    print("[restarts] " + json.dumps(restarts_res))
    print("[batched] " + json.dumps(batched_res))
    print("[greedy] " + json.dumps(greedy_res))
    print("[configs] " + json.dumps(configs_res))
    print("[serve] " + json.dumps(serve_res))
    print("[unroll] " + json.dumps(unroll_res))
    print("[examples] " + json.dumps(examples_res))
    print("[mesh] " + json.dumps(mesh_res))
    print("[trace] " + json.dumps(trace_res))
    print("[phases] wall-clock s " + json.dumps(phase_s))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
