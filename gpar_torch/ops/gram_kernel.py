"""Fused composite-kernel Gram construction: analyser, feature preparation,
the hand-written Hopper kernels' wrappers (forward and backward), their
plain PyTorch versions, and the autograd function around them.

Port of ``gpar_tpu/ops/pallas_gram.py`` (the one Pallas kernel of the JAX
package, ``_gram_kernel_body``, and its custom VJP).  The kernels are CUDA
C++, forward and backward in ``gpar_torch/csrc/gram.cu``, built by
``ops/_build.py``.

1. :func:`analyze_kernel` flattens a kernel tree into term specs.  Input
   rewrites (stretch, periodic embedding, select — and, unlike the JAX
   analyser, ``Gate``, folded in exactly like ``Stretch`` as ``x * gates``)
   become per-term feature maps computed outside the kernel; products of
   two rbf factors merge by feature concatenation; scalar weights ride
   along.  Supported leaves: EQ, RQ, Linear, Const.  A term wider than 128
   features, more than ``MAX_TERMS`` terms, or any other structure (e.g.
   ``RQ * RQ``) is refused and evaluated by ``ops.kernels.gram_eval``.
2. :func:`_prepare` evaluates the feature maps under ordinary autograd and
   concatenates them at their true widths into ``xf (n, D)`` / ``yf (m, D)``,
   ``D`` padded with zero columns to a multiple of 4, with the weights, RQ
   alphas and the constant offset in one small parameter vector ``par``.
3. :func:`gram_kernel_launch` and :func:`gram_bwd_kernel_launch` run the CUDA
   kernels on CUDA tensors; :func:`gram_terms_plain` and
   :func:`gram_terms_plain_vjp` are the same functions in PyTorch ops and
   are what a CPU tensor gets.  There is no fallback: a CUDA tensor
   launches the kernel or raises.
4. :class:`_GramFn` is the ``torch.autograd.Function`` on the prepared
   terms, ``(kinds, dims, xf, yf, par) -> K``: forward and backward are the
   kernels (their plain versions on the CPU).  Autograd carries the
   backward's ``(dxf, dyf, dpar)`` through the feature maps and ``par``
   into ``x``, ``y`` and the tree's hyperparameters; no tree is
   re-evaluated in the backward.
5. A leading batch axis.  The JAX package vmaps ``gram`` over
   Monte-Carlo samples in its ancestral tails, and over restarts and
   layers in its fits, where the tree's hyperparameters carry the batch
   too.  Either operand may be ``(B, n, W)``, the other ``(n, W)`` (shared
   by every element) or ``(B, n, W)``, and a tree's leaves may carry a
   leading batch axis (a scalar field ``(B,)``, a vector field ``(B, W)``):
   the features are then ``(B, n, D)`` and the parameters ``(B, 2T + 1)``,
   and the Gram is ``(B, n, m)``.  One launch of the forward kernel
   computes all B (``blockIdx.z``), a shared operand's stride 0; one launch
   of the backward kernel their VJP, the gradient of a shared operand
   summed over the batch.
"""

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import kernels as K

__all__ = [
    "analyze_kernel",
    "supported",
    "gram_fused_or_none",
    "gram_terms_plain",
    "gram_terms_plain_vjp",
    "gram_kernel_launch",
    "gram_bwd_kernel_launch",
    "prepare_terms",
    "reset_counters",
    "gram_kernel_launches",
    "gram_batched_kernel_launches",
    "gram_plain_cuda_calls",
    "gram_bwd_kernel_launches",
    "gram_bwd_batched_kernel_launches",
    "gram_eval_cuda_calls",
    "gram_autograd_calls",
    "counters",
    "add_counters",
    "set_counters",
    "map_leaves",
]

LANES = 128
#: Most terms one launch takes (``GPAR_GRAM_MAX_TERMS`` in ``gram.cu``).
MAX_TERMS = 32
KIND_CODES = {"rbf": 0, "rq": 1, "lin": 2}

# Counters.  Each is incremented by Python where the work is issued, so
# work captured into a CUDA graph would count once, at the capture, and a
# replay, which runs no Python, not at all.  The graph runner
# (``models/graphs.py``) therefore takes what a capture added back out
# (:func:`set_counters`) and adds it again on every replay
# (:func:`add_counters`): the counts are per launch that ran, replays
# included.

#: Launches of the CUDA Gram kernel (incremented by the wrapper only).
gram_kernel_launches = 0
#: Of those, the launches with a sample axis (one per batched Gram).
gram_batched_kernel_launches = 0
#: Launches of the CUDA Gram backward kernel (incremented by its wrapper only).
gram_bwd_kernel_launches = 0
#: Of those, the launches with a batch axis (one per batched Gram's VJP).
gram_bwd_batched_kernel_launches = 0
#: Grams of CUDA tensors evaluated by ``gram_eval`` because the analyser
#: refused the tree.
gram_plain_cuda_calls = 0
#: Calls of ``ops.kernels.gram_eval`` on CUDA tensors, from anywhere.
gram_eval_cuda_calls = 0
#: Fused Grams of CUDA tensors taken under autograd: each must come back
#: through the backward kernel once.
gram_autograd_calls = 0

_COUNTERS = (
    "gram_kernel_launches",
    "gram_batched_kernel_launches",
    "gram_bwd_kernel_launches",
    "gram_bwd_batched_kernel_launches",
    "gram_plain_cuda_calls",
    "gram_eval_cuda_calls",
    "gram_autograd_calls",
)


def counters():
    """The counters by name."""
    return {k: globals()[k] for k in _COUNTERS}


def set_counters(values):
    globals().update({k: values[k] for k in _COUNTERS})


def add_counters(delta):
    globals().update({k: globals()[k] + delta[k] for k in _COUNTERS})


def reset_counters():
    set_counters(dict.fromkeys(_COUNTERS, 0))


class _Term(NamedTuple):
    kind: str  # 'rbf' | 'rq' | 'lin'
    feats: object  # callable x (..., n, W) -> (..., n, dim) features
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
            k.k, weight, lambda x, f=fmap, s=K._rowvec(k.scales): f(x) / s, dim, terms,
            const_acc
        )
    if isinstance(k, K.Gate):
        return _collect(
            k.k, weight, lambda x, f=fmap, g=K._rowvec(k.gates): f(x) * g, dim, terms,
            const_acc
        )
    if isinstance(k, K.Periodic):
        return _collect(
            k.k,
            weight,
            lambda x, f=fmap, p=K._rowvec(k.period): K._embed_periodic(f(x), p),
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
                        lambda x, a=t1.feats, b=t2.feats: torch.cat([a(x), b(x)], dim=-1),
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
    """A weight, alpha or constant as a tensor: 0-d, or (B,) for a leaf
    with a batch axis."""
    if isinstance(v, torch.Tensor):
        v = v.to(dtype=like.dtype, device=like.device)
        return v.reshape(()) if v.numel() == 1 and v.ndim <= 1 else v
    return like.new_full((), float(v))


def _cat_lead(parts, n):
    """``parts`` (each (..., n, d)) broadcast over their leading axes and
    concatenated along the last one."""
    lead = torch.broadcast_shapes(*(u.shape[:-2] for u in parts))
    return torch.cat([u.expand(*lead, n, u.shape[-1]) for u in parts], dim=-1)


def _prepare(terms, const, x, y):
    """Feature maps -> ``(kinds, dims, xf, yf, par)``: features at their
    true widths, concatenated along the last axis and padded with zero
    columns to a width that is a multiple of 4 (rows load as 16-byte vectors
    in the kernels); ``par = [w_0..w_{T-1}, alpha_0..alpha_{T-1}, const]``;
    everything in ``x``'s dtype, computed under ordinary autograd.  ``x`` and
    ``y``, and the tree's leaves, may carry a leading batch axis: ``xf``
    (``yf``) then has it wherever ``x`` (``y``) or a leaf does, and ``par``
    is (B, 2T + 1) wherever a weight, alpha or constant does."""
    us, vs, dims, ws, alphas = [], [], [], [], []
    for t in terms:
        u = t.feats(x).to(x.dtype)
        v = t.feats(y).to(x.dtype)
        us.append(u)
        vs.append(v)
        dims.append(u.shape[-1])
        ws.append(_scalar(t.weight, x))
        alphas.append(_scalar(1.0 if t.alpha is None else t.alpha, x))
    pad = -sum(dims) % 4
    if pad:
        us.append(x.new_zeros((x.shape[-2], pad)))
        vs.append(x.new_zeros((y.shape[-2], pad)))
    xf = _cat_lead(us, x.shape[-2]).contiguous()
    yf = _cat_lead(vs, y.shape[-2]).contiguous()
    scal = ws + alphas + [_scalar(const, x)]
    lead = torch.broadcast_shapes(*(a.shape for a in scal))
    if lead:
        par = torch.stack([a.expand(lead) for a in scal], dim=-1)
    else:
        par = torch.stack(scal)
    kinds = tuple(t.kind for t in terms)
    return kinds, tuple(dims), xf, yf, par


def prepare_terms(kernel, x, y):
    """``(kinds, dims, xf, yf, par)`` for a supported tree (raises if the
    analyser refuses it) — the inputs of :func:`gram_kernel_launch` and
    :func:`gram_terms_plain`."""
    parsed = analyze_kernel(kernel, x.shape[-1])
    if parsed is None:
        raise ValueError("gram_kernel: kernel tree not supported by the analyser")
    return _prepare(*parsed, x, y)


def gram_terms_plain(kinds, dims, xf, yf, par):
    """The kernel's function in plain PyTorch ops, on prepared terms: the
    same per-term arithmetic (direct squared differences), in the same
    order (terms, then the constant).  Either operand may carry a leading
    batch axis (the other broadcasts), and ``par`` may be (B, 2T + 1)."""
    T = len(kinds)
    acc = None
    off = 0
    for t, (kind, d) in enumerate(zip(kinds, dims)):
        u = xf[..., off : off + d]
        v = yf[..., off : off + d]
        off += d
        w = _par(par, t)
        if kind == "lin":
            term = w * (u @ v.mT)
        else:
            diff = u[..., :, None, :] - v[..., None, :, :]
            s = torch.sum(diff * diff, dim=-1)
            if kind == "rbf":
                term = w * torch.exp(-0.5 * s)
            else:
                alpha = _par(par, T + t)
                term = w * torch.exp(-alpha * torch.log1p(s / (2.0 * alpha)))
        acc = term if acc is None else acc + term
    return acc + _par(par, 2 * T)


def _par(par, i):
    """Entry ``i`` of ``par``: 0-d, or (B, 1, 1) against (B, n, m) Grams."""
    return par[i] if par.ndim == 1 else par[:, i, None, None]


def gram_terms_plain_vjp(kinds, dims, xf, yf, par, g):
    """The backward kernel's function in plain PyTorch ops: the VJP of
    :func:`gram_terms_plain` for the upstream gradient ``g (n, m)``, written
    out per term with direct differences; returns ``(dxf, dyf, dpar)``,
    zero in the pad columns.  With ``g (B, n, m)`` each element's VJP in
    turn: the gradient of an operand with the batch axis per element, of a
    shared one summed over the elements."""
    if g.ndim == 3:
        return _plain_vjp_batched(kinds, dims, xf, yf, par, g)
    T = len(kinds)
    dxf, dyf = torch.zeros_like(xf), torch.zeros_like(yf)
    zero = par.new_zeros(())
    dws, das = [], []
    off = 0
    for t, (kind, d) in enumerate(zip(kinds, dims)):
        u = xf[:, off : off + d]
        v = yf[:, off : off + d]
        w = par[t]
        if kind == "lin":
            dxf[:, off : off + d] = w * (g @ v)
            dyf[:, off : off + d] = w * (g.T @ u)
            dws.append(torch.sum(g * (u @ v.T)))
            das.append(zero)
        else:
            diff = u[:, None, :] - v[None, :, :]
            s = torch.sum(diff * diff, dim=-1)
            if kind == "rbf":
                ge = g * torch.exp(-0.5 * s)
                P = -0.5 * w * ge
                dws.append(torch.sum(ge))
                das.append(zero)
            else:
                alpha = par[T + t]
                h = s / (2.0 * alpha)
                lr = torch.log1p(h)
                gr = g * torch.exp(-alpha * lr)
                P = -0.5 * w * gr / (1.0 + h)
                dws.append(torch.sum(gr))
                das.append(torch.sum(w * gr * (h / (1.0 + h) - lr)))
            dxf[:, off : off + d] = 2.0 * torch.einsum("ij,ijk->ik", P, diff)
            dyf[:, off : off + d] = -2.0 * torch.einsum("ij,ijk->jk", P, diff)
        off += d
    return dxf, dyf, torch.stack(dws + das + [torch.sum(g)])


def _plain_vjp_batched(kinds, dims, xf, yf, par, g):
    """:func:`gram_terms_plain_vjp` over ``g (B, n, m)``, element by element."""

    def el(a, b, rank):
        return a[b] if a.ndim == rank else a

    outs = [gram_terms_plain_vjp(kinds, dims, el(xf, b, 3), el(yf, b, 3), el(par, b, 2), g[b])
            for b in range(g.shape[0])]
    grads = []
    for i, (a, rank) in enumerate(((xf, 3), (yf, 3), (par, 2))):
        parts = torch.stack([o[i] for o in outs])
        grads.append(parts if a.ndim == rank else parts.sum(0))
    return tuple(grads)


def _check_terms(what, kinds, dims, xf, yf, par):
    """The checks both kernels' wrappers make on prepared terms: either
    operand may carry a leading batch axis, and ``par`` may be (B, 2T + 1);
    returns the batch size, or None when nothing carries one."""
    if not (xf.is_cuda and yf.is_cuda and par.is_cuda):
        raise ValueError(f"{what}: tensors must be on a CUDA device")
    if not (xf.device == yf.device == par.device):
        raise ValueError(f"{what}: tensors on different devices")
    if xf.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {xf.dtype}")
    if yf.dtype != xf.dtype or par.dtype != xf.dtype:
        raise TypeError(f"{what}: mixed dtypes")
    if xf.ndim not in (2, 3) or yf.ndim not in (2, 3) or xf.shape[-1] != yf.shape[-1]:
        raise ValueError(f"{what}: xf/yf must be (n, D) and (m, D), either with a leading "
                         "batch axis")
    T = len(kinds)
    if not 1 <= T <= MAX_TERMS or len(dims) != T or par.ndim not in (1, 2) \
            or par.shape[-1] != 2 * T + 1:
        raise ValueError(f"{what}: bad term specification")
    sizes = {a.shape[0] for a, rank in ((xf, 3), (yf, 3), (par, 2)) if a.ndim == rank}
    if len(sizes) > 1:
        raise ValueError(f"{what}: xf, yf and par have different batch sizes")
    D = xf.shape[-1]
    if not sum(dims) <= D < sum(dims) + 4 or D % 4 or any(not 0 < d <= LANES for d in dims):
        raise ValueError(f"{what}: term widths do not match the padded features")
    if not (xf.is_contiguous() and yf.is_contiguous() and par.is_contiguous()):
        raise ValueError(f"{what}: tensors must be contiguous")
    if (xf.data_ptr() | yf.data_ptr()) % 16:
        raise ValueError(f"{what}: features must be 16-byte aligned")
    return sizes.pop() if sizes else None


def _strides(xf, yf, par):
    """Each operand's stride between batch elements (0: shared)."""
    n, m, D = xf.shape[-2], yf.shape[-2], xf.shape[-1]
    return (n * D if xf.ndim == 3 else 0, m * D if yf.ndim == 3 else 0,
            par.shape[-1] if par.ndim == 2 else 0)


def _c_terms(kinds, dims):
    T = len(kinds)
    offs = [0]
    for d in dims[:-1]:
        offs.append(offs[-1] + d)
    arr = ctypes.c_int * T
    return arr(*(KIND_CODES[k] for k in kinds)), arr(*offs), arr(*dims)


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.gpar_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed ({rc}): {msg}")


def gram_kernel_launch(kinds, dims, xf, yf, par):
    """Launch the CUDA Gram kernel on prepared terms (CUDA tensors only);
    returns the (n, m) Gram, or the (S, n, m) Grams of one launch when
    ``xf`` (S, n, D), ``yf`` (S, m, D) or ``par`` (S, 2T + 1) carries a batch
    axis (an operand without it is shared by every element).  Raises on
    anything the kernel does not take and on a refused launch."""
    global gram_kernel_launches, gram_batched_kernel_launches
    size = _check_terms("gram_kernel_launch", kinds, dims, xf, yf, par)
    n, m, D = xf.shape[-2], yf.shape[-2], xf.shape[-1]
    batched = size is not None
    S = size if batched else 1
    out = torch.empty(((S,) if batched else ()) + (n, m), dtype=xf.dtype, device=xf.device)
    if n == 0 or m == 0 or S == 0:
        return out
    from ._build import load_library

    lib = load_library()
    fn = lib.gpar_gram_f32 if xf.dtype == torch.float32 else lib.gpar_gram_f64
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        rc = fn(
            xf.data_ptr(), yf.data_ptr(), par.data_ptr(), out.data_ptr(),
            S, n, m, D, *_strides(xf, yf, par), len(kinds), *_c_terms(kinds, dims), stream,
        )
    _raise_on(lib, rc, "gram kernel launch")
    gram_kernel_launches += 1
    gram_batched_kernel_launches += int(batched)
    return out


#: The backward kernel's tiles (``BwdTiles``/``BwdCfg`` in ``gram.cu``, which
#: checks the plan), by dtype: columns a block owns, and the rows per step
#: of the big tile and of the small one.
_BWD_COLS = {torch.float32: 128, torch.float64: 64}
_BWD_ROWS = {torch.float32: (64, 16), torch.float64: (32, 16)}
#: The backward's grid: blocks per SM at least ``_BWD_MIN_PER_SM`` (an SM
#: holds two at a time, so a third overlaps their loads and barriers), and
#: the busiest SM's blocks at most ``_BWD_BALANCE`` times the mean.
_BWD_MIN_PER_SM = 3
_BWD_BALANCE = 1.2


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bwd_plan(n, m, n_terms, dtype, device, batch=1):
    """``(column tiles, row splits, rows per split, rows per step)`` of one
    backward launch over ``batch`` elements (the grid is batch x terms x
    column tiles x row splits); the first three size its partial buffers.  The big
    tile, unless one step per split of it would still leave more than half
    the SMs without a block: such a grid is latency-bound, and the small
    tile gives it more blocks of less work each.  Rows are split in whole
    steps of the tile, into the fewest splits that give every SM at least
    ``_BWD_MIN_PER_SM`` blocks with the busiest SM's count within
    ``_BWD_BALANCE`` of the mean; where no split does, one step per split.
    The device's SM count is read once and cached (the plan runs inside
    CUDA graph captures)."""
    ct = -(-m // _BWD_COLS[dtype])
    sms = _sm_count(device)
    big, small = _BWD_ROWS[dtype]
    blocks = batch * n_terms * ct  # per row split
    step = small if 2 * blocks * -(-n // big) < sms else big
    steps = -(-n // step)
    for splits in range(1, steps + 1):
        rps = -(-steps // splits) * step
        r = -(-n // rps)
        per_sm = blocks * r / sms
        if per_sm >= _BWD_MIN_PER_SM and math.ceil(per_sm) <= _BWD_BALANCE * per_sm:
            break
    return ct, r, rps, step


def gram_bwd_kernel_launch(kinds, dims, xf, yf, par, g):
    """Launch the CUDA Gram backward kernel (CUDA tensors only): the VJP of
    :func:`gram_kernel_launch` for the upstream gradient ``g``, (n, m) or,
    batched, (B, n, m); returns ``(dxf, dyf, dpar)``, each shaped like its
    input (a shared operand's gradient summed over the batch).  Raises on
    anything the kernel does not take and on a refused launch."""
    global gram_bwd_kernel_launches, gram_bwd_batched_kernel_launches
    size = _check_terms("gram_bwd_kernel_launch", kinds, dims, xf, yf, par)
    n, m, D = xf.shape[-2], yf.shape[-2], xf.shape[-1]
    B = 1 if size is None else size
    want = (n, m) if size is None else (B, n, m)
    if g.shape != want or g.dtype != xf.dtype or g.device != xf.device:
        raise ValueError("gram_bwd_kernel_launch: g must be shaped like the forward's output")
    if not g.is_contiguous():
        raise ValueError("gram_bwd_kernel_launch: g must be contiguous")
    dxf, dyf, dpar = torch.empty_like(xf), torch.empty_like(yf), torch.empty_like(par)
    if n == 0 or m == 0:
        return dxf.zero_(), dyf.zero_(), dpar.zero_()
    from ._build import load_library

    lib = load_library()
    T = len(kinds)
    ct, r, rps, step = _bwd_plan(n, m, T, xf.dtype, xf.device, B)
    fn = lib.gpar_gram_bwd_f64 if xf.dtype == torch.float64 else lib.gpar_gram_bwd_f32
    # Per-block partials, summed in a fixed order by the second kernel.
    du_part = torch.empty((B, ct, n, D), dtype=xf.dtype, device=xf.device)
    dv_part = torch.empty((B, r, m, D), dtype=xf.dtype, device=xf.device)
    sc_part = torch.empty((3, T, B, ct, r), dtype=xf.dtype, device=xf.device)
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        rc = fn(
            xf.data_ptr(), yf.data_ptr(), par.data_ptr(), g.data_ptr(),
            dxf.data_ptr(), dyf.data_ptr(), dpar.data_ptr(),
            du_part.data_ptr(), dv_part.data_ptr(), sc_part.data_ptr(),
            B, n, m, D, *_strides(xf, yf, par), T, *_c_terms(kinds, dims), ct, r, rps, step,
            stream,
        )
    _raise_on(lib, rc, "gram backward kernel launch")
    gram_bwd_kernel_launches += 1
    gram_bwd_batched_kernel_launches += int(size is not None)
    return dxf, dyf, dpar


def map_leaves(k, fn):
    """``(tree, leaves)``: the kernel tree ``k`` with every tensor field
    replaced by ``fn(field)``, and those new tensors depth-first in field
    order.  For callers that differentiate with respect to a tree's
    hyperparameters or move it to another device."""
    changes, leaves = {}, []
    for f in dataclasses.fields(k):
        v = getattr(k, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
            leaves.append(changes[f.name])
        elif dataclasses.is_dataclass(v):
            changes[f.name], sub = map_leaves(v, fn)
            leaves.extend(sub)
    return (dataclasses.replace(k, **changes) if changes else k), leaves


# -- autograd ----------------------------------------------------------------


class _GramFn(torch.autograd.Function):
    """``(kinds, dims, xf, yf, par) -> K`` on prepared terms: the forward and
    backward kernels on CUDA tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, kinds, dims, xf, yf, par):
        ctx.terms = (kinds, dims)
        ctx.save_for_backward(xf, yf, par)
        if xf.is_cuda:
            return gram_kernel_launch(kinds, dims, xf, yf, par)
        return gram_terms_plain(kinds, dims, xf, yf, par)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xf, yf, par = ctx.saved_tensors
        g = g.contiguous()
        if xf.is_cuda:
            grads = gram_bwd_kernel_launch(*ctx.terms, xf, yf, par, g)
        else:
            grads = gram_terms_plain_vjp(*ctx.terms, xf, yf, par, g)
        return (None, None, *grads)


def gram_fused_or_none(kernel, x, y):
    """Fused Gram, or None when the analyser refuses the tree (the dispatch
    in :func:`gpar_torch.ops.kernels.gram` then evaluates ``gram_eval``).
    ``x``, ``y`` or the tree's leaves may carry a leading batch axis: the
    (B, n, m) Grams are one forward launch, and under autograd one backward
    launch."""
    global gram_autograd_calls
    if x.ndim not in (2, 3) or y.ndim not in (2, 3) or x.dtype not in (torch.float32, torch.float64):
        return None
    parsed = analyze_kernel(kernel, x.shape[-1])
    if parsed is None:
        return None
    prep = _prepare(*parsed, x, y)
    out = _GramFn.apply(*prep)
    if out.is_cuda and out.requires_grad:
        gram_autograd_calls += 1
    return out
