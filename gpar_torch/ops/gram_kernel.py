"""Fused composite-kernel Gram construction: analyser, feature preparation,
the hand-written Hopper kernel's wrapper, its plain PyTorch version, and
the autograd function around them.

Port of ``gpar_tpu/ops/pallas_gram.py`` (the one Pallas kernel of the JAX
package, ``_gram_kernel_body``).  The kernel itself is CUDA C++ in
``gpar_torch/csrc/gram.cu``, built by ``ops/_build.py``.

1. :func:`analyze_kernel` flattens a kernel tree into term specs.  Input
   rewrites (stretch, periodic embedding, select — and, unlike the JAX
   analyser, ``Gate``, folded in exactly like ``Stretch`` as ``x * gates``)
   become per-term feature maps computed outside the kernel; products of
   two rbf factors merge by feature concatenation; scalar weights ride
   along.  Supported leaves: EQ, RQ, Linear, Const.  A term wider than 128
   features, more than ``MAX_TERMS`` terms, or any other structure (e.g.
   ``RQ * RQ``) is refused and evaluated by ``ops.kernels.gram_eval``.
2. :func:`_prepare` evaluates the feature maps and concatenates them at
   their true widths into ``xf (n, D)`` / ``yf (m, D)``, with the weights,
   RQ alphas and the constant offset in one small parameter vector.
3. :func:`gram_kernel_launch` runs the CUDA kernel on CUDA tensors;
   :func:`gram_terms_plain` is the same function in PyTorch ops and is what
   a CPU tensor gets.  There is no fallback: a CUDA tensor launches the
   kernel or raises.
4. :class:`_GramFn` is the ``torch.autograd.Function``: the forward is the
   kernel (or the plain version on the CPU); the backward recomputes the
   plain recursion ``gram_eval`` under autograd and returns its VJP,
   mirroring the JAX package's ``_bwd``.  The tree's hyperparameter
   tensors enter ``forward`` as flattened arguments so their gradients are
   returned.
"""

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from . import kernels as K

__all__ = [
    "analyze_kernel",
    "supported",
    "gram_fused_or_none",
    "gram_terms_plain",
    "gram_kernel_launch",
    "prepare_terms",
    "reset_counters",
    "gram_kernel_launches",
    "gram_plain_cuda_calls",
]

LANES = 128
#: Most terms one launch takes (``GPAR_GRAM_MAX_TERMS`` in ``gram.cu``).
MAX_TERMS = 32
KIND_CODES = {"rbf": 0, "rq": 1, "lin": 2}

#: Launches of the CUDA Gram kernel (incremented by the wrapper only).
gram_kernel_launches = 0
#: Grams of CUDA tensors evaluated by ``gram_eval`` because the analyser
#: refused the tree.
gram_plain_cuda_calls = 0


def reset_counters():
    global gram_kernel_launches, gram_plain_cuda_calls
    gram_kernel_launches = 0
    gram_plain_cuda_calls = 0


class _Term(NamedTuple):
    kind: str  # 'rbf' | 'rq' | 'lin'
    feats: object  # callable x -> (n, dim) features
    weight: object  # float or 0-d tensor
    alpha: object  # RQ alpha or None
    dim: object  # feature width, or None when the input width is unknown


class _Unsupported(Exception):
    pass


def _collect(k, weight, fmap, dim, terms, const_acc):
    """Walk the tree carrying the accumulated scalar weight, the input
    feature map (outermost transform first) and its output width."""
    if isinstance(k, K.Sum):
        const_acc = _collect(k.k1, weight, fmap, dim, terms, const_acc)
        return _collect(k.k2, weight, fmap, dim, terms, const_acc)
    if isinstance(k, K.Scaled):
        return _collect(k.k, weight * k.scale, fmap, dim, terms, const_acc)
    if isinstance(k, K.Stretch):
        return _collect(
            k.k, weight, lambda x, f=fmap, s=k.scales: f(x) / s, dim, terms, const_acc
        )
    if isinstance(k, K.Gate):
        return _collect(
            k.k, weight, lambda x, f=fmap, g=k.gates: f(x) * g, dim, terms, const_acc
        )
    if isinstance(k, K.Periodic):
        return _collect(
            k.k,
            weight,
            lambda x, f=fmap, p=k.period: K._embed_periodic(f(x), p),
            None if dim is None else 2 * dim,
            terms,
            const_acc,
        )
    if isinstance(k, K.Select):
        return _collect(
            k.k,
            weight,
            lambda x, f=fmap, i=k.inds: K._select(f(x), i),
            len(k.inds),
            terms,
            const_acc,
        )
    if isinstance(k, K.Product):
        # Products of two single-rbf factors merge by feature
        # concatenation, exp(-a) exp(-b) = exp(-(a + b)): the locally
        # periodic kernel (``gpar/regression.py:127-129``).
        sub1, sub2 = [], []
        c1 = _collect(k.k1, 1.0, fmap, dim, sub1, 0.0)
        c2 = _collect(k.k2, 1.0, fmap, dim, sub2, 0.0)
        if len(sub1) == 1 and len(sub2) == 1 and not _nonzero(c1) and not _nonzero(c2):
            t1, t2 = sub1[0], sub2[0]
            if t1.kind == "rbf" and t2.kind == "rbf":
                terms.append(
                    _Term(
                        "rbf",
                        lambda x, a=t1.feats, b=t2.feats: torch.cat([a(x), b(x)], dim=1),
                        weight * t1.weight * t2.weight,
                        None,
                        None if t1.dim is None or t2.dim is None else t1.dim + t2.dim,
                    )
                )
                return const_acc
        raise _Unsupported(f"product {type(k.k1).__name__} * {type(k.k2).__name__}")
    if isinstance(k, K.EQ):
        terms.append(_Term("rbf", fmap, weight, None, dim))
        return const_acc
    if isinstance(k, K.RQ):
        terms.append(_Term("rq", fmap, weight, k.alpha, dim))
        return const_acc
    if isinstance(k, K.Linear):
        terms.append(_Term("lin", fmap, weight, None, dim))
        return const_acc
    if isinstance(k, K.Const):
        return const_acc + weight * k.value
    if isinstance(k, K.ZeroKernel):
        return const_acc
    raise _Unsupported(type(k).__name__)


def _nonzero(c):
    return not (isinstance(c, float) and c == 0.0)


def analyze_kernel(kernel, d=None):
    """Flatten a kernel tree into ``(terms, const)``, or None if the kernel
    cannot take it.  ``d`` is the input width; when given, trees with a
    term wider than 128 features are refused too."""
    terms = []
    try:
        const = _collect(kernel, 1.0, lambda x: x, d, terms, 0.0)
    except _Unsupported:
        return None
    if not terms or len(terms) > MAX_TERMS:
        return None
    if d is not None and any(t.dim > LANES for t in terms):
        return None
    return terms, const


def supported(kernel, d=None):
    return analyze_kernel(kernel, d) is not None


def _scalar(v, like):
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device).reshape(())
    return like.new_full((), float(v))


def _prepare(terms, const, x, y):
    """Feature maps -> ``(kinds, dims, xf, yf, par)``: features at their
    true widths, concatenated; ``par = [w_0..w_{T-1}, alpha_0..alpha_{T-1},
    const]``; everything in ``x``'s dtype."""
    us, vs, dims, ws, alphas = [], [], [], [], []
    for t in terms:
        u = t.feats(x).to(x.dtype)
        v = t.feats(y).to(x.dtype)
        us.append(u)
        vs.append(v)
        dims.append(u.shape[1])
        ws.append(_scalar(t.weight, x))
        alphas.append(_scalar(1.0 if t.alpha is None else t.alpha, x))
    xf = torch.cat(us, dim=1).contiguous()
    yf = torch.cat(vs, dim=1).contiguous()
    par = torch.stack(ws + alphas + [_scalar(const, x)])
    kinds = tuple(t.kind for t in terms)
    return kinds, tuple(dims), xf, yf, par


def prepare_terms(kernel, x, y):
    """``(kinds, dims, xf, yf, par)`` for a supported tree (raises if the
    analyser refuses it) — the inputs of :func:`gram_kernel_launch` and
    :func:`gram_terms_plain`."""
    parsed = analyze_kernel(kernel, x.shape[1])
    if parsed is None:
        raise ValueError("gram_kernel: kernel tree not supported by the analyser")
    return _prepare(*parsed, x, y)


def gram_terms_plain(kinds, dims, xf, yf, par):
    """The kernel's function in plain PyTorch ops, on prepared terms: the
    same per-term arithmetic (direct squared differences), in the same
    order (terms, then the constant)."""
    T = len(kinds)
    acc = None
    off = 0
    for t, (kind, d) in enumerate(zip(kinds, dims)):
        u = xf[:, off : off + d]
        v = yf[:, off : off + d]
        off += d
        w = par[t]
        if kind == "lin":
            term = w * (u @ v.T)
        else:
            diff = u[:, None, :] - v[None, :, :]
            s = torch.sum(diff * diff, dim=-1)
            if kind == "rbf":
                term = w * torch.exp(-0.5 * s)
            else:
                alpha = par[T + t]
                term = w * torch.exp(-alpha * torch.log1p(s / (2.0 * alpha)))
        acc = term if acc is None else acc + term
    return acc + par[2 * T]


def gram_kernel_launch(kinds, dims, xf, yf, par):
    """Launch the CUDA Gram kernel on prepared terms (CUDA tensors only);
    returns the (n, m) Gram.  Raises on anything the kernel does not take
    and on a refused launch."""
    global gram_kernel_launches
    if not (xf.is_cuda and yf.is_cuda and par.is_cuda):
        raise ValueError("gram_kernel_launch: tensors must be on a CUDA device")
    if not (xf.device == yf.device == par.device):
        raise ValueError("gram_kernel_launch: tensors on different devices")
    if xf.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gram_kernel_launch: unsupported dtype {xf.dtype}")
    if yf.dtype != xf.dtype or par.dtype != xf.dtype:
        raise TypeError("gram_kernel_launch: mixed dtypes")
    if xf.ndim != 2 or yf.ndim != 2 or xf.shape[1] != yf.shape[1]:
        raise ValueError("gram_kernel_launch: xf/yf must be (n, D) and (m, D)")
    T = len(kinds)
    if not 1 <= T <= MAX_TERMS or len(dims) != T or par.shape != (2 * T + 1,):
        raise ValueError("gram_kernel_launch: bad term specification")
    if sum(dims) != xf.shape[1] or any(not 0 < d <= LANES for d in dims):
        raise ValueError("gram_kernel_launch: term widths do not match the features")
    if not (xf.is_contiguous() and yf.is_contiguous() and par.is_contiguous()):
        raise ValueError("gram_kernel_launch: tensors must be contiguous")
    n, m, D = xf.shape[0], yf.shape[0], xf.shape[1]
    out = torch.empty((n, m), dtype=xf.dtype, device=xf.device)
    if n == 0 or m == 0:
        return out
    from ._build import load_library

    lib = load_library("gram")
    offs = [0]
    for d in dims[:-1]:
        offs.append(offs[-1] + d)
    arr = ctypes.c_int * T
    c_kinds = arr(*(KIND_CODES[k] for k in kinds))
    c_offs = arr(*offs)
    c_dims = arr(*dims)
    fn = lib.gpar_gram_f32 if xf.dtype == torch.float32 else lib.gpar_gram_f64
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        rc = fn(
            xf.data_ptr(), yf.data_ptr(), par.data_ptr(), out.data_ptr(),
            n, m, D, T, c_kinds, c_offs, c_dims, stream,
        )
    if rc != 0:
        msg = lib.gpar_cuda_error_string(rc).decode()
        raise RuntimeError(f"gram kernel launch failed ({rc}): {msg}")
    gram_kernel_launches += 1
    return out


# -- autograd ----------------------------------------------------------------


def _leaves(k):
    """The tree's tensor fields, depth-first in field order."""
    out = []
    for f in dataclasses.fields(k):
        v = getattr(k, f.name)
        if isinstance(v, K.Kernel):
            out.extend(_leaves(v))
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _with_leaves(k, leaves):
    """The same tree with its tensor fields replaced, in :func:`_leaves`
    order; returns ``(tree, remaining leaves)``."""
    changes = {}
    for f in dataclasses.fields(k):
        v = getattr(k, f.name)
        if isinstance(v, K.Kernel):
            changes[f.name], leaves = _with_leaves(v, leaves)
        elif isinstance(v, torch.Tensor):
            changes[f.name], leaves = leaves[0], leaves[1:]
    return (dataclasses.replace(k, **changes) if changes else k), leaves


class _GramFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, x, y, *leaves):
        kinds, dims, xf, yf, par = prepare_terms(kernel, x, y)
        if x.is_cuda:
            out = gram_kernel_launch(kinds, dims, xf, yf, par)
        else:
            out = gram_terms_plain(kinds, dims, xf, yf, par)
        ctx.kernel = kernel
        ctx.save_for_backward(x, y, *leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[1])
            ys = y.detach().requires_grad_(need[2])
            lv = [l.detach().requires_grad_(n) for l, n in zip(leaves, need[3:])]
            tree, _ = _with_leaves(ctx.kernel, lv)
            out = K.gram_eval(tree, xs, ys)
            wrt = [t for t in (xs, ys, *lv) if t.requires_grad]
            grads = iter(
                torch.autograd.grad(out, wrt, g, allow_unused=True) if wrt else ()
            )
        return (None, *(next(grads) if t.requires_grad else None for t in (xs, ys, *lv)))


def gram_fused_or_none(kernel, x, y):
    """Fused Gram, or None when the analyser refuses the tree (the dispatch
    in :func:`gpar_torch.ops.kernels.gram` then evaluates ``gram_eval``)."""
    if x.ndim != 2 or y.ndim != 2 or x.dtype not in (torch.float32, torch.float64):
        return None
    if analyze_kernel(kernel, x.shape[1]) is None:
        return None
    return _GramFn.apply(kernel, x, y, *_leaves(kernel))

