"""Kernel algebra as a tree of frozen dataclasses.

Port of ``gpar_tpu/ops/kernels.py`` (which replaces the ``stheno`` kernels of
the reference, ``gpar/regression.py:92-180``): ``EQ``, ``RQ``, ``Linear``,
``Const``, ``ZeroKernel``, sums, products, scalar scalings and the input
rewrites ``Stretch``, ``Periodic``, ``Select`` and ``Gate``.  Hyperparameters
are tensor fields (autograd flows through them); structure is the tree.

Evaluation has two routes:

- :func:`gram_eval` / :func:`kdiag` — the plain recursion over the
  combinators, in PyTorch ops.  It is the reference semantics and the
  evaluator of any tree the kernel's analyser refuses.
- :func:`gram` — the dispatch: a tree the analyser of
  ``ops/gram_kernel.py`` accepts runs through the hand-written kernel (on
  a CUDA tensor) or its plain PyTorch version (on a CPU tensor); other
  trees run through :func:`gram_eval`.

A tree whose leaves carry a leading batch axis (a scalar field (B,), a
vector field (B, W); the JAX package vmaps its fits' objectives over
restarts and layers) is B trees: ``gram`` gives (B, n, m) and ``kdiag``
(B, n), the inputs shared by every element or carrying the batch too.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import default_dtype

__all__ = [
    "Kernel",
    "gram_eval",
    "EQ",
    "RQ",
    "Linear",
    "Const",
    "ZeroKernel",
    "Sum",
    "Product",
    "Scaled",
    "Stretch",
    "Periodic",
    "Select",
    "Gate",
    "gram",
    "kdiag",
    "sq_dists",
]


def _asparam(v):
    """Hyperparameter as a tensor: tensors pass through, NumPy arrays keep
    their dtype, Python numbers take the default dtype."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v)
    return torch.as_tensor(v, dtype=default_dtype())


class Kernel:
    """Base class providing the combinator algebra
    (``gpar/regression.py:110,127-138,146,166,178``)."""

    def __add__(self, other):
        other = _coerce(other)
        if isinstance(other, ZeroKernel):
            return self
        if isinstance(self, ZeroKernel):
            return other
        return Sum(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        if isinstance(other, Kernel):
            if isinstance(self, ZeroKernel) or isinstance(other, ZeroKernel):
                return ZeroKernel()
            return Product(self, other)
        if isinstance(self, ZeroKernel):
            return ZeroKernel()
        return Scaled(self, _asparam(other))

    def __rmul__(self, other):
        return self.__mul__(other)

    def stretch(self, scales):
        """Divide inputs by per-dimension length scales."""
        return Stretch(self, _asparam(scales))

    def periodic(self, period):
        """Map each input dim to a (cos, sin) pair with the given period,
        then apply this kernel in the embedded (2m-dim) space
        (``gpar/regression.py:115-118``)."""
        return Periodic(self, _asparam(period))

    def select(self, inds):
        """Restrict the kernel to a subset of input columns
        (``gpar/regression.py:178``)."""
        return Select(self, tuple(int(i) for i in inds))

    def gate(self, gates):
        """Multiply input columns by a 0/1 gate vector: the shape-uniform
        analogue of :meth:`select` (a gated-out dimension contributes
        nothing to distances, inner products or periodic embeddings)."""
        return Gate(self, _asparam(gates))

    def __call__(self, x, y=None):
        x = _upcol(x)
        y = x if y is None else _upcol(y)
        return gram(self, x, y)

    def elwise(self, x):
        return kdiag(self, _upcol(x))


def _coerce(v):
    if isinstance(v, Kernel):
        return v
    return Const(_asparam(v))


def _upcol(x):
    return x[:, None] if x.ndim == 1 else x


@dataclass(frozen=True, eq=False)
class EQ(Kernel):
    """Exponentiated quadratic: ``k(x, y) = exp(-1/2 |x - y|^2)``."""


@dataclass(frozen=True, eq=False)
class RQ(Kernel):
    """Rational quadratic: ``k(x, y) = (1 + |x-y|^2 / (2 alpha))^(-alpha)``
    (``gpar/regression.py:107``)."""

    alpha: torch.Tensor


@dataclass(frozen=True, eq=False)
class Linear(Kernel):
    """Dot-product kernel: ``k(x, y) = x . y``."""


@dataclass(frozen=True, eq=False)
class Const(Kernel):
    """Constant kernel ``k(x, y) = value`` (``gpar/regression.py:138``)."""

    value: torch.Tensor


@dataclass(frozen=True, eq=False)
class ZeroKernel(Kernel):
    """Additive identity (``gpar/regression.py:94-95``)."""


@dataclass(frozen=True, eq=False)
class Sum(Kernel):
    k1: Kernel
    k2: Kernel


@dataclass(frozen=True, eq=False)
class Product(Kernel):
    k1: Kernel
    k2: Kernel


@dataclass(frozen=True, eq=False)
class Scaled(Kernel):
    k: Kernel
    scale: torch.Tensor


@dataclass(frozen=True, eq=False)
class Stretch(Kernel):
    k: Kernel
    scales: torch.Tensor


@dataclass(frozen=True, eq=False)
class Periodic(Kernel):
    k: Kernel
    period: torch.Tensor


@dataclass(frozen=True, eq=False)
class Select(Kernel):
    k: Kernel
    inds: tuple


@dataclass(frozen=True, eq=False)
class Gate(Kernel):
    """Input rewrite ``x -> x * gates`` (see :meth:`Kernel.gate`)."""

    k: Kernel
    gates: torch.Tensor


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def sq_dists(x, y):
    """Pairwise squared Euclidean distances via the matmul identity
    ``|x_i|^2 + |y_j|^2 - 2 x_i . y_j``, clamped at zero (over the last two
    axes; leading axes broadcast)."""
    x2 = torch.sum(x * x, dim=-1)[..., :, None]
    y2 = torch.sum(y * y, dim=-1)[..., None, :]
    return torch.clamp_min(x2 + y2 - 2.0 * (x @ y.mT), 0.0)


def _embed_periodic(x, period):
    """Per-dimension (cos, sin) embedding of the last axis, interleaved as
    ``[cos x_0, sin x_0, cos x_1, sin x_1, ...]``."""
    theta = 2.0 * math.pi * x / period
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1).flatten(-2)


def _select(x, inds):
    return x[..., list(inds)]


def _rowvec(v):
    """A vector field against (..., n, W) inputs: (W,) as it is, a batched
    (B, W) as (B, 1, W)."""
    return v if v.ndim <= 1 else v[..., None, :]


def _sc(v, k):
    """A scalar field against (..., n, m) Grams (``k = 2``) or (..., n)
    diagonals (``k = 1``): a batched (B,) gets ``k`` trailing unit axes."""
    return v[(...,) + (None,) * k] if v.ndim == 1 and v.numel() > 1 else v


def gram(k, x, y):
    """The full pairwise kernel matrix ``k(x, y)`` of shape (n, m); (S, n, m)
    when ``x`` or ``y`` carries a leading sample axis (forward only).

    A tree the Gram kernel's analyser accepts goes through the
    hand-written kernel (``ops/gram_kernel.py``; its plain PyTorch version
    for CPU tensors); any other tree goes through :func:`gram_eval`."""
    from . import gram_kernel

    out = gram_kernel.gram_fused_or_none(k, x, y)
    if out is not None:
        return out
    if x.is_cuda:
        gram_kernel.gram_plain_cuda_calls += 1
    return gram_eval(k, x, y)


def gram_eval(k, x, y):
    """Plain evaluation of the kernel tree (recursion over the
    combinators).  Calls on CUDA tensors are counted
    (``gram_kernel.gram_eval_cuda_calls``): the main path makes none."""
    if x.is_cuda:
        from . import gram_kernel

        gram_kernel.gram_eval_cuda_calls += 1
    return _gram_eval(k, x, y)


def _gram_eval(k, x, y):
    if isinstance(k, Sum):
        return _gram_eval(k.k1, x, y) + _gram_eval(k.k2, x, y)
    if isinstance(k, Product):
        return _gram_eval(k.k1, x, y) * _gram_eval(k.k2, x, y)
    if isinstance(k, Scaled):
        return _sc(k.scale, 2) * _gram_eval(k.k, x, y)
    if isinstance(k, Stretch):
        s = _rowvec(k.scales)
        return _gram_eval(k.k, x / s, y / s)
    if isinstance(k, Periodic):
        p = _rowvec(k.period)
        return _gram_eval(k.k, _embed_periodic(x, p), _embed_periodic(y, p))
    if isinstance(k, Select):
        return _gram_eval(k.k, _select(x, k.inds), _select(y, k.inds))
    if isinstance(k, Gate):
        g = _rowvec(k.gates)
        return _gram_eval(k.k, x * g, y * g)
    if isinstance(k, EQ):
        return torch.exp(-0.5 * sq_dists(x, y))
    if isinstance(k, RQ):
        a = _sc(k.alpha, 2)
        return (1.0 + sq_dists(x, y) / (2.0 * a)) ** (-a)
    if isinstance(k, Linear):
        return x @ y.mT
    if isinstance(k, Const):
        v = _sc(k.value.to(x.dtype), 2)
        return v.expand(torch.broadcast_shapes(v.shape, _gram_shape(x, y)))
    if isinstance(k, ZeroKernel):
        return x.new_zeros(_gram_shape(x, y))
    raise TypeError(f"Unknown kernel type: {type(k)!r}")


def _gram_shape(x, y):
    return (*torch.broadcast_shapes(x.shape[:-2], y.shape[:-2]), x.shape[-2], y.shape[-2])


def kdiag(k, x):
    """The kernel's diagonal ``k(x_i, x_i)`` of shape (n,) (the Titsias
    trace term, ``gpar/model.py:286-289``); (B, n) for a batched tree."""
    if isinstance(k, Sum):
        return kdiag(k.k1, x) + kdiag(k.k2, x)
    if isinstance(k, Product):
        return kdiag(k.k1, x) * kdiag(k.k2, x)
    if isinstance(k, Scaled):
        return _sc(k.scale, 1) * kdiag(k.k, x)
    if isinstance(k, Stretch):
        return kdiag(k.k, x / _rowvec(k.scales))
    if isinstance(k, Periodic):
        return kdiag(k.k, _embed_periodic(x, _rowvec(k.period)))
    if isinstance(k, Select):
        return kdiag(k.k, _select(x, k.inds))
    if isinstance(k, Gate):
        return kdiag(k.k, x * _rowvec(k.gates))
    if isinstance(k, (EQ, RQ)):
        return x.new_ones(x.shape[:-1])
    if isinstance(k, Linear):
        return torch.sum(x * x, dim=-1)
    if isinstance(k, Const):
        v = _sc(k.value.to(x.dtype), 1)
        return v.expand(torch.broadcast_shapes(v.shape, x.shape[:-1]))
    if isinstance(k, ZeroKernel):
        return x.new_zeros(x.shape[:-1])
    raise TypeError(f"Unknown kernel type: {type(k)!r}")
