"""Kernel trees and data shared by the gpar_torch tests, built without JAX.

The tree cases take a framework object ``fw`` with the kernel module as
``fw.K``, a parameter constructor ``fw.P`` and ``fw.bench_tree(pi)``, so the
parity tests build each tree in both packages (``test_torch_kernels._FW``)
and the card-only tests (``test_torch_cuda.py``, which must not import JAX)
build the port's half with :class:`TorchFW`.
"""

import numpy as np
import torch

import gpar_torch.ops.kernels as TK
from gpar_torch.models.regressor import GPARRegressor as TReg
from gpar_torch.models.regressor import _model_generator as t_generator
from gpar_torch.params.store import Vars as TVars
from gpar_torch.params.store import load_latents

__all__ = ["CASES", "FUSED", "TorchFW", "bench_kwargs", "chain_data", "scan_step", "_inputs",
           "_layer_kernel_tree"]


def chain_data(n=100, p=3, seed=0, n_test=20):
    """A small closed-downwards chain shaped like the benchmark's data
    (each output a nonlinear function of the previous one and the input)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    cols = [np.sin(x) - x**2 / 50.0]
    for i in range(1, p):
        cols.append(np.cos(cols[-1]) ** 2 + np.sin((i + 1) * x / 3.0) / (1 + i / 8.0))
    y = np.stack(cols, axis=1) + 0.05 * rng.standard_normal((n, p))
    x_test = np.linspace(0.2, 9.8, n_test)
    return x, y, x_test


def scan_step(device, dtype=torch.float64, dense=False, restarts=1, rule="device", w=None):
    """``(reg, step)``: the benchmark's model (8 inducing points, or dense)
    conditioned on ``chain_data(100, 3)`` with every seventh row of output 2
    missing and the weights ``w``, and a loaded
    :class:`~gpar_torch.models.fused.ScanStep` of its fit on ``device``
    (``restarts`` starts, the perturbations from seed 3, its evaluations
    on the jitter rule ``rule``)."""
    from gpar_torch.models.fused import ScanStep, build_scan_fit_plan

    x, y, _ = chain_data(n=100, p=3, seed=0)
    y[::7, 2] = np.nan
    kw = dict(bench_kwargs(n_ind=8), **({"x_ind": None} if dense else {}))
    reg = TReg(**kw, device=device, dtype=dtype)
    reg.condition(x, y, w)
    reg._ensure_vars(reg.p)
    names = reg.vs.select(None)
    plan = build_scan_fit_plan(reg, names)
    x_pad, rows = reg._bucket_fit_inputs(plan)
    zi = x_pad.new_zeros((0, plan.m)) if dense else reg.x_ind
    step = ScanStep(plan, x_pad.shape[0], zi.shape[0], dtype, device, restarts=restarts, rule=rule)
    pert = torch.as_tensor(np.random.default_rng(3).normal(size=(plan.p, restarts - 1, plan.s_max)),
                           dtype=dtype, device=device)
    step.load(reg.vs.latent_vector(names), x_pad, rows, zi, pert)
    return reg, step


def bench_kwargs(n_ind=8, lo=0.0, hi=10.0):
    """The benchmark's model configuration (``bench.py:54-69``) with
    ``n_ind`` inducing points."""
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
        x_ind=np.linspace(lo, hi, n_ind),
    )


class TorchFW:
    """The port's constructors for the tree cases (``dtype`` a NumPy dtype)."""

    name = "torch"

    def __init__(self, dtype):
        self.dtype = dtype
        self.K = TK
        self.P = lambda a: torch.as_tensor(np.asarray(a, dtype))

    def bench_tree(self, pi, m=1):
        """Layer ``pi``'s kernel exactly as the estimator builds it for the
        benchmark's configuration, at seeded, perturbed hyperparameters."""
        cfg = TReg(**bench_kwargs(), device="cpu").model_config
        tdt = torch.float32 if self.dtype == np.float32 else torch.float64
        vs = TVars(dtype=tdt, device="cpu")
        gen = t_generator(vs, m, pi, **cfg)
        gen()
        r = np.random.default_rng(100 + pi)
        snap0 = vs.snapshot()
        load_latents(vs, {k: snap0[k] + 0.3 * r.standard_normal(np.shape(snap0[k])) for k in vs.names})
        f, _ = gen()
        return f.kernel


def _layer_kernel_tree(fw, m=1, P1=3, pi=2):
    """A gated layer kernel built like the scan body's ``_layer_kernel``
    (``gpar_tpu/models/fused.py:547-607``): input terms gated to the first
    ``m`` columns, output terms gated to the ``pi`` modelled outputs."""
    P, K = fw.P, fw.K
    out_gate = (np.arange(P1) < pi).astype(float)
    gate_in = P(np.r_[np.ones(m), np.zeros(P1)])
    gate_out = P(np.r_[np.zeros(m), out_gate])
    kin = P(1.3) * K.EQ().stretch(P(np.r_[[0.7] * m, np.ones(P1)]))
    kernel = kin.gate(gate_in)
    kernel = kernel + K.Linear().stretch(P(np.r_[np.ones(m), [3.0, 2.0, 4.0][:P1]])).gate(gate_out)
    kernel = kernel + (P(1.0) * P(0.8)) * K.EQ().stretch(
        P(np.r_[np.ones(m), [0.9, 1.4, 1.1][:P1]])
    ).gate(gate_out)
    return kernel


# name -> (build(fw) -> kernel, input width)
CASES = {
    "eq": (lambda fw: fw.K.EQ(), 2),
    "rq": (lambda fw: fw.K.RQ(fw.P(0.8)), 2),
    "linear": (lambda fw: fw.K.Linear(), 2),
    "const": (lambda fw: fw.K.Const(fw.P(1.3)), 2),
    "zero-sum": (lambda fw: fw.K.ZeroKernel() + fw.K.EQ(), 2),
    "sum": (lambda fw: 2.0 * fw.K.EQ() + fw.K.Linear() + fw.K.Const(fw.P(0.3)), 2),
    "product": (
        lambda fw: fw.K.EQ().stretch(fw.P([0.7, 1.3])) * fw.K.EQ().stretch(fw.P([2.0, 0.5])),
        2,
    ),
    "scaled-stretch-eq": (lambda fw: fw.P(1.7) * fw.K.EQ().stretch(fw.P([0.6, 1.8])), 2),
    "stretch-linear": (lambda fw: fw.K.Linear().stretch(fw.P([0.6, 1.8])), 2),
    "periodic": (
        lambda fw: 0.5
        * (
            fw.K.EQ().stretch(fw.P([0.8, 1.2, 1.5, 0.7])).periodic(fw.P([1.1, 1.9]))
            * fw.K.EQ().stretch(fw.P([6.0, 8.0]))
        ),
        2,
    ),
    "select": (
        lambda fw: (fw.P(0.9) * fw.K.EQ().stretch(fw.P([1.5]))).select([1])
        + fw.K.Linear().select([0]),
        2,
    ),
    "gate": (
        lambda fw: (fw.P(1.2) * fw.K.EQ().stretch(fw.P([0.5, 0.9]))).gate(fw.P([1.0, 0.0])),
        2,
    ),
    "rq-product": (lambda fw: fw.K.RQ(fw.P(0.5)) * fw.K.RQ(fw.P(0.7)), 2),
    "bench-pi0": (lambda fw: fw.bench_tree(0), 1),
    "bench-pi1": (lambda fw: fw.bench_tree(1), 2),
    "bench-pi2": (lambda fw: fw.bench_tree(2), 3),
    "layer-kernel-gated": (lambda fw: _layer_kernel_tree(fw), 4),
    # 264 features (rbf and lin terms of 120, rq of 24): wider than the CUDA
    # kernels' staging chunks and the backward's default shared memory.
    "wide": (
        lambda fw: fw.P(1.1) * fw.K.EQ().stretch(fw.P(np.linspace(6.0, 10.0, 120)))
        + fw.K.Linear().stretch(fw.P(np.linspace(8.0, 12.0, 120)))
        + fw.K.RQ(fw.P(0.8)).stretch(fw.P(np.linspace(2.0, 4.0, 24))).select(list(range(24))),
        120,
    ),
    # Terms at the edges of the CUDA backward's lane maps (rbf 2, rq 15,
    # lin 17, rq 33, rbf 64 features): its du/dv groups of 8, 4, 2 and 1
    # features in every combination, and past 24 features its chunks.
    "edges": (
        lambda fw: fw.K.EQ().stretch(fw.P([0.9, 1.4])).select([0, 1])
        + fw.K.RQ(fw.P(0.7)).stretch(fw.P(np.linspace(2.0, 4.0, 15))).select(list(range(15)))
        + fw.P(0.6) * fw.K.Linear().stretch(fw.P(np.linspace(6.0, 9.0, 17))).select(list(range(17)))
        + fw.K.RQ(fw.P(1.3)).stretch(fw.P(np.linspace(3.0, 6.0, 33))).select(list(range(33)))
        + fw.P(1.2) * fw.K.EQ().stretch(fw.P(np.linspace(6.0, 10.0, 64))),
        64,
    ),
}
#: Cases the Pallas TPU kernel's test file covers (tests/test_pallas_gram.py)
#: plus the benchmark's select tree, a gate tree, the wide tree and the
#: edge-width tree.
FUSED = [
    "eq", "scaled-stretch-eq", "rq", "stretch-linear", "sum", "periodic",
    "select", "gate", "bench-pi1", "bench-pi2", "layer-kernel-gated", "wide", "edges",
]


def _inputs(d, dtype, n=37, m=23, seed=5):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, d)).astype(dtype), r.normal(size=(m, d)).astype(dtype)
