"""GPARRegressor — the user-facing estimator.

Port of the main-path slice of ``gpar_tpu/models/regressor.py`` (itself a
rebuild of the reference ``gpar/regression.py:200-597``): the constructor,
the per-layer kernel generator with its variable-naming contract verbatim,
``condition``, ``fit`` (``fix`` True and False, ``greedy``), ``predict`` /
``fit_predict`` (both ``replace`` modes), posterior and prior ``sample``,
``logpdf``, ``precompute``, ``warmup``, and ``get_variables`` /
``load_latents``.

Design, in PyTorch terms:

- Data is ingested on the host (NumPy): transform, NaN-aware
  normalisation and the closed-downwards row plan; the inputs are uploaded
  once.
- ``fit(fix=True)`` with ``fused=True`` (the default) is the scan-fused
  fit of ``models/fused.py``: every layer runs one step at uniform shapes
  (gates for ``select``, 0/1 row masks for the NaN filtering, rows padded
  to a shape bucket), L-BFGS on the layer's objective and then one
  augmentation step.  On a CUDA device the step's bodies are captured once
  as CUDA graphs and replayed for every layer and iteration
  (``models/graphs.py``); ``cuda_graphs=False`` runs them eagerly, as a
  CPU tensor always does.  ``fused=False`` is the per-layer driver, the
  oracle: one L-BFGS per layer through ``GPAR.logpdf``; once layer ``pi``
  is fitted its posterior is computed once and its means at the data rows
  and at the inducing inputs are appended for layer ``pi + 1`` (the rule
  of the JAX package's ``_augment_cols``).
- ``predict`` with ``replace=True`` is the scan predict tail
  (``fused.make_scan_predict_tail``): the test rows are bucketed and
  masked, every layer is conditioned once, and all Monte-Carlo samples of
  a layer are one (S, n) matmul against one covariance factor (the inputs
  of every layer are posterior means, so the covariance is shared by all
  draws); the mean and the 2.5 / 97.5 percentiles are reduced on the
  device.  ``torch.quantile`` with ``interpolation="linear"`` is
  ``jnp.percentile``'s default.
- ``predict`` with ``replace=False`` (the constructor's default) and
  ``sample`` run per-sample ancestral chains
  (``fused.make_scan_ancestral_tail``; the prior's
  ``fused.make_scan_prior_tail``): every sample carries its own augmented
  test inputs, so per chunk of samples each layer takes Grams with a
  sample axis (one kernel launch each), a batched posterior covariance
  and one batched sampling factor.
- The posterior-factor cache (:meth:`GPARRegressor.precompute`): the
  per-layer posterior factors of the conditioned data are computed once
  per latents and kept in one slot, so later ``predict`` / ``sample`` /
  posterior ``logpdf`` calls run only the test-point work
  (``fused.make_scan_cached_tail``; the per-sample tail and the score take
  the stack one layer at a time).  A dense stack over
  ``config.posterior_cache_max_bytes``, or ``config.posterior_cache =
  False``, conditions anew in every call, each layer's factors inside the
  tail's loop (``fused.posterior_factor_layers``), so no stack is held.
- Entry points run on ``device`` (default ``"cuda"``; raises without a
  card unless ``device="cpu"``).  Randomness comes from a
  ``torch.Generator`` or from caller-supplied standard normals.
- ``logpdf`` scores the prior through the scan-fused chain
  (``fused.make_scan_logpdf_body``) and the posterior through
  ``fused.make_scan_posterior_logpdf_tail``, each layer's training factors
  taken when the tail needs them; another scored width and
  ``sample_missing`` take the GP core (``GPAR | data``, ``GPAR.logpdf``).
- ``fit(fix=False)`` minimises, at each position, the NLL of the whole
  chain up to it jointly over the latents of its layers: eagerly through
  ``fused.make_scan_free_fit_body`` (``fused=True``) or through
  ``GPAR.logpdf`` (``fused=False``).

- ``fit(restarts=R)`` runs each position's L-BFGS from the current
  latents and ``R - 1`` perturbations of them and keeps the best finite
  optimum, on every route: the scan step and the joint fit optimise the R
  starts as one batch (batched Grams and factorisations), the per-layer
  driver one start after the other.  ``fused="batched"`` fits all layers
  of a dense, fully observed, ``replace=False`` model as one batch
  (``fused.make_batched_fit_body``).

- ``fit(greedy=True)`` with ``compat=False`` first orders the outputs
  greedily (:meth:`GPARRegressor._greedy_order`): at each position all
  remaining candidates are scored as one batch, one batched L-BFGS over
  the candidates of the position's single-layer objective, every Gram one
  batched launch.  Layer ``pi`` then models output ``order[pi]``; every
  entry point takes and returns the outputs in their original columns.

- :meth:`GPARRegressor.warmup` runs the entry points of a scratch
  estimator on synthetic data of a shape, so that the row bucket's graphed
  steps are captured (and the kernels built) before real data arrives;
  ``gpar_torch.utils.checkpoint`` saves and loads the estimator in the JAX
  package's format.  Every entry point takes ``torch.Tensor`` inputs as
  data (detached, read on the host).

Both the sparse model (``x_ind`` given) and the dense one (``x_ind=None``,
the exact marginal likelihood over the data rows) run through every entry
point above.  Not ported yet: ``fused="unroll"`` and the mesh (the greedy
scorer's candidate axis sharded over devices included).
"""

import time

import numpy as np
import torch

from ..config import bucket_rows, config, default_dtype, resolve_device
from ..gp.core import GP, Obs, PseudoObs
from ..ops.kernels import EQ, RQ, Const, Linear, ZeroKernel, gram, kdiag
from ..ops.linalg import floor_noise, resolve_epsilon, titsias_factors
from ..params.lbfgs import lbfgs_minimize, lbfgs_minimize_batched, new_stats
from ..params.optim import minimise_l_bfgs_b, restart_normals
from ..params.store import Vars, load_latents
from ..utils.rng import default_generator
from .gpar import GPAR, per_output

__all__ = ["GPARRegressor", "log_transform", "squishing_transform"]

#: Log transform for the data (``gpar/regression.py:22``).
log_transform = (torch.log, torch.exp)

#: Squishing transform for the data (``gpar/regression.py:25-28``).
squishing_transform = (
    lambda x: torch.sign(x) * torch.log(1 + torch.abs(x)),
    lambda x: torch.sign(x) * (torch.exp(torch.abs(x)) - 1),
)


def _vector_from_init(init, length):
    """Scalar -> broadcast vector; vector -> validated prefix
    (``gpar/regression.py:31-46``)."""
    if np.size(init) == 1:
        return init * np.ones(length)
    flat = np.squeeze(init)
    if np.ndim(flat) != 1:
        raise ValueError(
            f"Hyperparameter initialiser has shape {np.shape(init)}; "
            "expected a scalar or a flat vector."
        )
    if np.size(flat) < length:
        raise ValueError(
            f"Hyperparameter initialiser supplies {np.size(flat)} values "
            f"but this layer needs {length}."
        )
    return np.array(flat)[:length]


def _determine_indices(m, pi, markov):
    """Input / previous-output column indices honouring the Markov order
    (``gpar/regression.py:49-59``)."""
    p_last = pi - 1
    p_start = 0 if markov is None else max(p_last - (markov - 1), 0)
    p_num = p_last - p_start + 1
    m_inds = list(range(m))
    p_inds = list(range(m + p_start, m + p_last + 1))
    return m_inds, p_inds, p_num


def _host(a):
    """``a`` as the port's host code takes it: a ``torch.Tensor`` (on any
    device, requiring grad or not) detached and brought to the host as
    NumPy; anything else unchanged."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a


def _uprank_np(x, dtype):
    x = np.asarray(_host(x), dtype=dtype)
    if x.ndim == 0:
        return x[None, None]
    if x.ndim == 1:
        return x[:, None]
    if x.ndim == 2:
        return x
    raise ValueError(f"Cannot uprank tensor of rank {x.ndim}.")


def _model_generator(
    vs,
    m,  # input dimensionality
    pi,  # which output this layer models
    scale,
    scale_tie,
    per,
    per_period,
    per_scale,
    per_decay,
    input_linear,
    input_linear_scale,
    linear,
    linear_scale,
    nonlinear,
    nonlinear_scale,
    rq,
    markov,
    noise,
):
    """Per-layer prior constructor; kernel composition and the variable
    naming scheme mirror ``gpar/regression.py:72-182`` verbatim."""

    def model():
        kernel_inputs = ZeroKernel()
        kernel_outputs = ZeroKernel()

        m_inds, p_inds, p_num = _determine_indices(m, pi, markov)

        # Mandatory stationary term on the raw inputs.
        variance = vs.bnd(name=f"{pi}/input/var", init=1.0)
        scales = vs.bnd(
            name=f"{0 if scale_tie else pi}/input/scales",
            init=_vector_from_init(scale, m),
        )
        if rq:
            k = RQ(vs.bnd(name=f"{pi}/input/alpha", init=1e-2, lower=1e-3, upper=1e3))
        else:
            k = EQ()
        kernel_inputs += variance * k.stretch(scales)

        # Optional locally-periodic term (2*m scales for the embedding).
        if per:
            variance = vs.bnd(name=f"{pi}/input/per/var", init=1.0)
            scales = vs.bnd(
                name=f"{pi}/input/per/scales",
                init=_vector_from_init(per_scale, 2 * m),
            )
            periods = vs.bnd(
                name=f"{pi}/input/per/pers",
                init=_vector_from_init(per_period, m),
            )
            decays = vs.bnd(
                name=f"{pi}/input/per/decay",
                init=_vector_from_init(per_decay, m),
            )
            kernel_inputs += (
                variance * EQ().stretch(scales).periodic(periods) * EQ().stretch(decays)
            )

        # Optional dot-product term on the raw inputs.
        if input_linear:
            scales = vs.bnd(
                name=f"{pi}/input/lin/scales",
                init=_vector_from_init(input_linear_scale, m),
            )
            const = vs.get(name=f"{pi}/input/lin/const", init=1.0)
            kernel_inputs += Linear().stretch(scales) + Const(const)

        # Dependencies on earlier outputs: a dot-product term ...
        if linear and pi > 0:
            scales = vs.bnd(
                name=f"{pi}/output/lin/scales",
                init=_vector_from_init(linear_scale, p_num),
            )
            kernel_outputs += Linear().stretch(scales)

        # ... and/or a stationary (EQ/RQ) term.
        if nonlinear and pi > 0:
            variance = vs.bnd(name=f"{pi}/output/nonlin/var", init=1.0)
            scales = vs.bnd(
                name=f"{pi}/output/nonlin/scales",
                init=_vector_from_init(nonlinear_scale, p_num),
            )
            if rq:
                k = RQ(
                    vs.bnd(
                        name=f"{pi}/output/nonlin/alpha",
                        init=1e-2,
                        lower=1e-3,
                        upper=1e3,
                    )
                )
            else:
                k = EQ()
            kernel_outputs += variance * k.stretch(scales)

        # Observation noise; the 1e-8 lower bound matches the reference
        # (``gpar/regression.py:172``).
        noise_variance = vs.bnd(
            name=f"{pi}/noise",
            init=_vector_from_init(noise, pi + 1)[pi],
            lower=1e-8,
        )

        f = GP(kernel_inputs.select(m_inds) + kernel_outputs.select(p_inds))
        return f, noise_variance

    return model


def _construct_gpar(reg, vs, m, p):
    """A fresh GPAR with ``p`` layers (``gpar/regression.py:185-190``)."""
    gpar = GPAR(replace=reg.replace, impute=reg.impute, x_ind=reg.x_ind)
    for pi in range(p):
        gpar = gpar.add_layer(_model_generator(vs, m, pi, **reg.model_config))
    return gpar


class GPARRegressor:
    """GPAR regressor (``gpar/regression.py:200-597``).

    The arguments are those of the reference, plus ``device`` (default
    ``config.device``, i.e. ``"cuda"``) and ``dtype`` (default
    ``config.dtype``).  ``compat`` affects :meth:`logpdf` and whether
    ``fit(greedy=True)`` runs.
    """

    def __init__(
        self,
        replace=False,
        impute=True,
        scale=1.0,
        scale_tie=False,
        per=False,
        per_period=1.0,
        per_scale=1.0,
        per_decay=10.0,
        input_linear=False,
        input_linear_scale=100.0,
        linear=True,
        linear_scale=100.0,
        nonlinear=False,
        nonlinear_scale=1.0,
        rq=False,
        markov=None,
        noise=0.1,
        x_ind=None,
        normalise_y=True,
        transform_y=(lambda x: x, lambda x: x),
        compat=True,
        device=None,
        dtype=None,
    ):
        self.device = resolve_device(device)
        self.dtype = default_dtype() if dtype is None else dtype
        self._np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        self.replace = replace
        self.impute = impute
        self.sparse = x_ind is not None
        self.x_ind = None if x_ind is None else self._upload(_uprank_np(x_ind, self._np_dtype))
        self.model_config = {
            "scale": scale,
            "scale_tie": scale_tie,
            "per": per,
            "per_period": per_period,
            "per_scale": per_scale,
            "per_decay": per_decay,
            "input_linear": input_linear,
            "input_linear_scale": input_linear_scale,
            "linear": linear,
            "linear_scale": linear_scale,
            "nonlinear": nonlinear,
            "nonlinear_scale": nonlinear_scale,
            "rq": rq,
            "markov": markov,
            "noise": noise,
        }
        self.vs = Vars(dtype=self.dtype, device=self.device)
        self.is_conditioned = False
        #: The most recent fit: per-layer initial and final NLL, L-BFGS
        #: iterations, wall-clock; on the scan path also the CUDA graph
        #: replays, host reads, backtracking trials and the Cholesky
        #: factorisations that escalated past the first jitter rung.
        self.last_fit_report = None
        self.compat = compat
        self.normalise_y = normalise_y
        self._means = self._stds = None
        self._transform_y, self._untransform_y = transform_y
        self._vars_ready = None
        self._y_cache = None
        self._plan_cache = self._bucket_cache = None  # scan plan, bucketed inputs
        #: The posterior-factor slot, ``(key, stacked factors)`` or None
        #: (:meth:`_posterior_factors`).
        self._factor_cache = None
        self.x = None  # conditioned inputs (device)
        self._x_np = self._y_np = self._w_np = None
        self.n = self.m = self.p = None
        #: Greedy output ordering (original column per layer), set by
        #: ``fit(greedy=True)`` with ``compat=False``; None is the identity.
        #: Layer ``pi`` models output ``order[pi]``; user-facing inputs and
        #: outputs stay in the original column order.
        self.order = None
        #: The most recent greedy search: per position the candidates, their
        #: optimised NLLs and observed rows, the host reads and backtracking
        #: trials of its batched L-BFGS; the search's wall-clock.
        self.last_greedy_report = None

    def _permute_outputs(self, a, strict=True):
        """Original column order -> layer order.  With a greedy ordering in
        effect the binding between columns and layers is defined only for
        the full set of fitted outputs: ``strict`` raises on another width;
        otherwise (a prior sample of another chain length, whose columns
        are greedy positions) such a width passes through unchanged."""
        if a is None or self.order is None or (not strict and a.shape[1] != len(self.order)):
            return a
        if a.shape[1] != len(self.order):
            raise ValueError(
                f"A greedy output ordering over {len(self.order)} outputs "
                f"is in effect; data with {a.shape[1]} output columns "
                "cannot be matched to layers. Pass all fitted outputs, or "
                "clear `self.order`."
            )
        return a[:, np.asarray(self.order)]

    def _unpermute_outputs(self, a, strict=True):
        """Layer order -> original column order, on the last axis (sample
        batches are (s, n, p)); ``strict`` as in :meth:`_permute_outputs`."""
        if a is None or self.order is None or (not strict and a.shape[-1] != len(self.order)):
            return a
        if a.shape[-1] != len(self.order):
            raise ValueError(
                f"A greedy output ordering over {len(self.order)} outputs "
                f"is in effect; cannot relabel {a.shape[-1]} sampled "
                "columns."
            )
        return a[..., np.argsort(np.asarray(self.order))]

    def _upload(self, a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(a, dtype=self._np_dtype), device=self.device)

    def _ensure_vars(self, p, m=None):
        """Instantiate every layer's variables once per (m, p); ``m``
        defaults to the conditioned data's input width."""
        m = self.m if m is None else m
        if self._vars_ready == (m, p):
            return
        for pi in range(p):
            _construct_gpar(self, self.vs, m, pi + 1).layers[pi]()
        self._vars_ready = (m, p)

    def get_variables(self):
        """All hyperparameters, name -> NumPy value
        (``gpar/regression.py:328-337``)."""
        return {
            name: self.vs[name].detach().cpu().numpy() for name in self.vs.names
        }

    def load_latents(self, latents, order=None):
        """Set the store's latents from a name -> latent dict (the format of
        ``gpar_tpu``'s ``Vars.snapshot()``), after instantiating every
        layer's variables for the conditioned data.  ``order`` is the
        output ordering the latents were fitted under (the source
        estimator's ``order``; None is the identity): the conditioned
        outputs are rebound to layers under it."""
        if not self.is_conditioned:
            raise RuntimeError("load_latents() needs conditioned data (call condition() first).")
        self._reorder(order)
        self._ensure_vars(self.p)
        load_latents(self.vs, latents)
        self._factor_cache = None

    def _reorder(self, order):
        """Rebind the conditioned data's columns to layers under ``order``:
        the host copies and the normalisation statistics are permuted as
        :meth:`condition` would have permuted them (the transform and the
        normalisation act column by column)."""
        new = np.arange(self.p) if order is None else np.asarray(order, dtype=np.int64)
        if sorted(new.tolist()) != list(range(self.p)):
            raise ValueError(f"order {new.tolist()} is not a permutation of the {self.p} outputs")
        old = np.arange(self.p) if self.order is None else np.asarray(self.order)
        idx = np.argsort(old)[new]  # new layer j <- old layer holding column new[j]
        self.order = None if order is None else new
        if np.array_equal(idx, np.arange(self.p)):
            return
        if self._means is not None:
            self._means, self._stds = self._means[:, idx], self._stds[:, idx]
        self._set_outputs(self._y_np[:, idx], self._w_np[:, idx])

    def _set_outputs(self, y_np, w_np):
        """The conditioned outputs and weights (host copies, layer order),
        the ``per_output`` plan of both ``keep`` modes, and no cached scan
        plan, bucketed inputs or posterior factors."""
        self._y_np, self._w_np = y_np, w_np
        self._y_cache = {
            keep: list(per_output(y_np, w_np, keep=keep)) for keep in (False, True)
        }
        self._plan_cache = self._bucket_cache = self._factor_cache = None

    def condition(self, x, y, w=None):
        """Condition the model on data without training
        (``gpar/regression.py:339-389``): host-side transform, NaN-aware
        per-output normalisation (std == 0 -> 1), the closed-downwards row
        plan, and one upload of the inputs.  Under a greedy ordering the
        output columns (and weights) are permuted to layer order first; a
        width mismatch raises before any state changes."""
        y_np = self._permute_outputs(_uprank_np(y, self._np_dtype))
        w_np = None if w is None else self._permute_outputs(_uprank_np(w, self._np_dtype))
        x_np = _uprank_np(x, self._np_dtype)
        y_np = np.asarray(self._transform_y(torch.as_tensor(y_np)), dtype=self._np_dtype)
        self.n, self.m = x_np.shape
        self.p = y_np.shape[1]
        if self.normalise_y:
            means, stds = [], []
            for i in range(self.p):
                y_i = y_np[~np.isnan(y_np[:, i]), i]
                means.append(np.mean(y_i))
                std = np.std(y_i, ddof=1) if y_i.size > 1 else 0.0
                stds.append(std if std > 0 else 1.0)
            self._means = np.asarray(means, dtype=self._np_dtype)[None, :]
            self._stds = np.asarray(stds, dtype=self._np_dtype)[None, :]
            y_np = (y_np - self._means) / self._stds
        if w_np is None:
            w_np = np.ones(y_np.shape, dtype=self._np_dtype)
        self._x_np = x_np
        self._set_outputs(y_np, w_np)
        self.x = self._upload(x_np)
        self._vars_ready = None
        self.is_conditioned = True

    def _undo_transforms(self, y):
        if self.normalise_y and self._means is not None:
            y = y * self._upload(self._stds) + self._upload(self._means)
        return self._untransform_y(y)

    def fit(self, x, y, w=None, greedy=False, fix=True, iters=None, gtol=1e-9, memory_size=10,
            fused=True, restarts=1, cuda_graphs=True, restart_scale=1.0, generator=None,
            restart_normals=None):
        """Fit the model to data (``gpar/regression.py:391-459``), one
        L-BFGS per layer position.  With ``fix=True`` (default) position
        ``pi`` optimises layer ``pi``'s variables and the layer is fixed
        from then on; with ``fix=False`` it optimises the variables of
        layers ``0..pi`` jointly on the NLL of their whole chain, and
        ``last_fit_report["layer_nll"][pi]`` is that chain's NLL.

        ``fused=True`` (default): the scan-fused fit (``models/fused.py``);
        with ``fix=True`` its layer step is captured as CUDA graphs on a
        CUDA device unless ``cuda_graphs=False``, with ``fix=False`` it runs
        eagerly.  ``fused=False``: the per-layer driver.  ``"batched"``
        (``fix=True`` only): every layer's L-BFGS as one batch, for a dense,
        fully observed, ``replace=False`` model without ``scale_tie``
        (``fused.make_batched_fit_body``); ``"unroll"`` is not ported.

        ``restarts > 1``: each position's L-BFGS also starts from
        ``restarts - 1`` perturbations of the latents, ``restart_scale``
        times standard normals in the latent space, and keeps the best
        finite optimum (``layer_iters`` are its iterations, ``layer_nll0``
        the unperturbed start's).  ``restart_normals`` supplies the normals,
        a list of one array per layer in the route's shape: (restarts - 1,
        s_max), the layer's padded latent span, for the scan and
        ``"batched"``; (restarts - 1, n_z), the prefix span, for the joint
        fit; (restarts - 1, d_pi), the optimised latents, for the per-layer
        driver.  Otherwise they come from ``generator`` (default: the
        device's generator of ``utils.rng``).

        ``iters`` is the most L-BFGS iterations per optimisation; None
        means 1000 for the fit and 100 for the greedy search, the JAX
        package's defaults.

        ``greedy=True`` orders the outputs greedily before the fit.  The
        reference documents the option but raises
        (``gpar/regression.py:410,448``): with ``compat=True`` so does this
        method; with ``compat=False`` the search runs
        (:meth:`_greedy_order`, with ``iters``, ``gtol`` and
        ``memory_size``), its permutation is kept in ``order`` and the fit
        runs on the permuted outputs, on any route above.  Every entry
        point takes and returns the outputs in their original columns."""
        if fused == "batched" and not fix:
            raise ValueError("fused='batched' requires independent layer fits; fit(fix=False) "
                             "optimises layers jointly: use fused=True or fused=False.")
        if fused not in (True, False, "batched"):
            raise NotImplementedError(f"gpar_torch: fit(fused={fused!r}) is not ported yet")
        if int(restarts) != restarts or restarts < 1:
            raise ValueError(f"restarts must be a positive integer, got {restarts!r}")
        restarts = int(restarts)
        if greedy:
            if self.compat:
                # Reference parity (``gpar/regression.py:448-449``).
                raise NotImplementedError("Greedy search is not implemented yet.")
            self.order = None
            self.condition(x, y, w)  # identity order: transforms and statistics
            self.order = self._greedy_order(100 if iters is None else iters, gtol, memory_size)
        iters = 1000 if iters is None else iters
        self.condition(x, y, w)
        self._ensure_vars(self.p)
        t0 = time.perf_counter()
        starts = dict(restarts=restarts, restart_scale=restart_scale, generator=generator,
                      normals=restart_normals)
        if fused:
            report = self._fit_scan(iters, gtol, memory_size, cuda_graphs, fix, fused, **starts)
        else:
            nll0, nll, its = self._fit_per_layer_loop(iters, gtol, memory_size, fix, **starts)
            report = {"layer_nll0": np.asarray(nll0), "layer_nll": np.asarray(nll),
                      "layer_iters": np.asarray(its), "fused": False, "graph_replays": 0}
        report["restarts"] = restarts
        report["wall_clock_s"] = time.perf_counter() - t0
        if greedy:
            report["greedy_s"] = self.last_greedy_report["wall_clock_s"]
        self.last_fit_report = report

    def _greedy_order(self, iters=100, gtol=1e-9, memory_size=10):
        """Greedily order the outputs by conditional marginal likelihood
        (``gpar_tpu/models/regressor.py:812-888``; the search the GPAR
        paper, arXiv:1802.07182, proposes and the reference stubs out).

        At position ``k``, with the outputs ``S`` selected, each remaining
        candidate ``o`` is scored by the per-observation optimised log
        marginal likelihood of one layer-``k`` GP ``[x, y[:, S]] ->
        y[:, o]`` on the rows where ``o`` and all of ``S`` are observed,
        the sparse scheme and the Markov order honoured; all candidates of
        a position are one batch (:meth:`_greedy_position_nlls`).  A
        candidate with no observed rows, or a non-finite optimum, scores
        ``-inf``; ties go to the first remaining candidate.  Needs
        :meth:`condition` with the identity order.

        The batched scorer factors masked full-size matrices where the
        per-candidate oracle (:meth:`_greedy_layer_nll`) factors the
        observed rows only; the two can pick different permutations only
        when candidate scores are near-tied.

        Returns the permutation: layer ``pi`` models output ``ret[pi]``.
        """
        t0 = time.perf_counter()
        y_np, w_np, x_np = self._y_np, self._w_np, self._x_np
        remaining, selected, positions = list(range(self.p)), [], []
        for position in range(self.p):
            masks = np.stack([~np.isnan(y_np[:, selected + [o]]).any(axis=1) for o in remaining])
            n_obs = masks.sum(axis=1)
            # Rows with a selected output missing are masked out of every
            # candidate's likelihood, so the zero-filled NaNs feed only
            # neutralised rows.
            x_aug = np.concatenate([x_np, np.nan_to_num(y_np[:, selected], nan=0.0)], axis=1)
            stats = new_stats()
            nlls = self._greedy_position_nlls(
                position, x_aug, np.nan_to_num(y_np[:, remaining].T, nan=0.0),
                w_np[:, remaining].T, masks, iters, gtol, memory_size, stats=stats,
            )
            with np.errstate(invalid="ignore"):
                scores = np.where(n_obs > 0, -nlls / np.maximum(n_obs, 1), -np.inf)
            scores = np.where(np.isfinite(scores), scores, -np.inf)
            best = remaining[int(np.argmax(scores))]
            positions.append(dict(candidates=list(remaining), nll=nlls.tolist(),
                                  n_obs=n_obs.tolist(), chosen=best, **stats))
            selected.append(best)
            remaining.remove(best)
        self.last_greedy_report = dict(order=list(selected), positions=positions,
                                       wall_clock_s=time.perf_counter() - t0)
        return np.asarray(selected)

    def _greedy_position_nlls(self, position, x_aug, ys, ws, masks, iters, gtol, memory_size,
                              stats=None):
        """Optimised single-layer NLLs of all C candidates of one greedy
        position as one batch (``gpar_tpu/models/regressor.py:890-1081``,
        the JAX package's ``vmap`` over candidates of ``lbfgs_traced``).

        ``x_aug`` (n, m + position) is shared by every candidate; ``ys``,
        ``ws`` and ``masks`` are (C, n).  Rows are padded to their bucket
        (y 0, w 1, mask 0: a masked row is exactly neutral).  Each
        candidate starts from the same fresh initialisation, a throwaway
        store of the position's layer, so that scores are comparable and a
        second search scores as the first.  The layer's kernel tree is the
        estimator's own (``_model_generator`` at ``position``) with leaves
        that carry the candidate axis, so every evaluation takes one
        batched launch of the Gram kernel per Gram, and its gradient one of
        the backward kernel; the factorisations take the jitter ladder per
        candidate on the device.  One batched L-BFGS
        (``params.lbfgs.lbfgs_minimize_batched``) runs every candidate's
        trajectory; each candidate's final NLL is returned, (C,) NumPy.
        ``stats`` (``new_stats()``) receives its host reads and trials, the
        candidates' iterations and the escalated factorisations."""
        from .fused import _masked_dense_factors

        vs = Vars(dtype=self.dtype, device=self.device)
        _model_generator(vs, self.m, position, **self.model_config)()
        names = vs.select(None)
        pad = bucket_rows(ys.shape[1]) - ys.shape[1]
        x_t = self._upload(np.pad(x_aug, ((0, pad), (0, 0))))
        y_t = self._upload(np.pad(ys, ((0, 0), (0, pad))))
        w_t = self._upload(np.pad(ws, ((0, 0), (0, pad)), constant_values=1.0))
        mask = self._upload(np.pad(masks.astype(self._np_dtype), ((0, 0), (0, pad))))
        r = y_t * mask
        C = ys.shape[0]
        escalations = torch.zeros((), dtype=torch.int64, device=self.device)
        if self.sparse:
            # The inducing inputs with the prior-mean (zero) estimates of the
            # selected outputs (``gpar/model.py:291-305``).
            z_aug = torch.cat([self.x_ind, self.x_ind.new_zeros((self.x_ind.shape[0], position))],
                              dim=1)

        def nll(z):
            view = vs.with_latent_vector(names, z)
            f, noise = _model_generator(view, self.m, position, **self.model_config)()
            noise_w = floor_noise(noise.reshape(C, 1) / w_t)
            if self.sparse:
                kern = f.kernel
                return -titsias_factors(gram(kern, z_aug, z_aug), gram(kern, z_aug, x_t),
                                        kdiag(kern, x_t), r, torch.zeros_like(r), noise_w,
                                        mask=mask, escalations=escalations)[0]
            K = gram(f.kernel, x_t, x_t)
            return -_masked_dense_factors(K, r, mask, noise_w, resolve_epsilon(K.dtype),
                                          escalations)[0]

        z0 = vs.latent_vector(names).expand(C, -1)
        _, f, its, _ = lbfgs_minimize_batched(nll, z0, iters=iters, gtol=gtol, memory=memory_size,
                                              stats=stats)
        out = torch.cat([f, its.to(f.dtype), escalations.to(f.dtype).reshape(1)]).cpu().numpy()
        if stats is not None:
            stats["host_syncs"] += 1
            stats["iterations"] = out[C:2 * C].astype(np.int64).tolist()
            stats["ladder_escalations"] = int(out[-1])
        return out[:C]

    def _greedy_layer_nll(self, pi, x_aug, y_t, w_t, iters, gtol, memory_size):
        """Optimised single-layer NLL of one greedy candidate on its own
        (filtered) rows through the GP core, ``PseudoObs`` or ``Obs``: the
        per-candidate oracle of :meth:`_greedy_position_nlls`
        (``gpar_tpu/models/regressor.py:1083-1140``), from the same fresh
        initialisation, by one L-BFGS (``params.lbfgs.lbfgs_minimize``).
        Returns a Python float."""
        vs = Vars(dtype=self.dtype, device=self.device)
        _model_generator(vs, self.m, pi, **self.model_config)()
        names = vs.select(None)
        x_t, y_v, w_v = (self._upload(a) for a in (_uprank_np(x_aug, self._np_dtype), y_t, w_t))
        if self.sparse:
            z_aug = torch.cat([self.x_ind, self.x_ind.new_zeros((self.x_ind.shape[0], pi))], dim=1)

        def nll(z):
            f, noise = _model_generator(vs.with_latent_vector(names, z), self.m, pi,
                                        **self.model_config)()
            if self.sparse:
                return -PseudoObs(f(z_aug), f(x_t, noise / w_v), y_v).logpdf
            return -Obs(f(x_t, noise / w_v), y_v).logpdf

        _, f, _, _ = lbfgs_minimize(nll, vs.latent_vector(names), iters=iters, gtol=gtol,
                                    memory=memory_size)
        return float(f)

    def _scan_fit_plan(self, names):
        """The conditioned data's scan plan, cached per variable layout."""
        from .fused import build_scan_fit_plan

        key = tuple(names)
        if self._plan_cache is None or self._plan_cache[0] != key:
            self._plan_cache = (key, build_scan_fit_plan(self, names))
        return self._plan_cache[1]

    def _bucket_fit_inputs(self, plan):
        """``(x_pad, rows)``: the conditioned data padded to its row bucket
        on the device, and the per-layer row arrays derived there; cached
        per dataset and bucket."""
        from .fused import device_bucket_inputs

        n_b = bucket_rows(plan.n)
        if self._bucket_cache is None or self._bucket_cache[0] != n_b:
            self._bucket_cache = (n_b, *device_bucket_inputs(
                self._x_np, self._y_np, self._w_np, n_b=n_b, impute=bool(self.impute),
                device=self.device,
            ))
        return self._bucket_cache[1:]

    def _layer_normals(self, normals, restarts, width, generator):
        """The restarts' standard normals of every layer, (p, restarts - 1,
        width): the caller's list of per-layer arrays, or draws from
        ``generator``; None for a single start."""
        if restarts == 1:
            return None
        shape = (restarts - 1, width)
        if normals is None:
            return restart_normals(None, (self.p, *shape), self.dtype, self.device, generator)
        if len(normals) != self.p:
            raise ValueError(f"restart_normals has {len(normals)} layers; expected {self.p}")
        return torch.stack([restart_normals(a, shape, self.dtype, self.device)
                            for a in normals])

    def _fit_scan(self, iters, gtol, memory_size, cuda_graphs, fix=True, fused=True, restarts=1,
                  restart_scale=1.0, generator=None, normals=None):
        from .fused import make_batched_fit_body, make_scan_fit_body, make_scan_free_fit_body

        names = self.vs.select(None)
        plan = self._scan_fit_plan(names)
        x_pad, rows = self._bucket_fit_inputs(plan)
        width = plan.s_max if fix else plan.n_z  # a start's latents
        common = (iters, gtol, memory_size, restarts, restart_scale)
        if fused == "batched":
            program = make_batched_fit_body(plan, *common, rows_traced=True)
        elif fix:
            program = make_scan_fit_body(plan, self.x_ind, *common, rows_traced=True,
                                         cuda_graphs=cuda_graphs)
        else:
            program = make_scan_free_fit_body(plan, self.x_ind, *common, rows_traced=True)
        stats = new_stats()
        z, nll, its, nll0 = program(self.vs.latent_vector(names), x_pad, rows, stats=stats,
                                    normals=self._layer_normals(normals, restarts, width,
                                                                generator))
        self.vs.set_latent_vector(names, z)
        return {"layer_nll0": nll0, "layer_nll": nll, "layer_iters": its, "fused": True, **stats}

    def _fit_per_layer_loop(self, iters, gtol, memory_size, fix=True, restarts=1,
                            restart_scale=1.0, generator=None, normals=None):
        if normals is not None and len(normals) != self.p:
            raise ValueError(f"restart_normals has {len(normals)} layers; expected {self.p}")
        y_cached = self._y_cache
        x_pi, x_ind_pi = self.x, self.x_ind
        nll0, nll, its = [], [], []
        for pi in range(self.p):

            def objective(vs, pi=pi, x_pi=x_pi, x_ind_pi=x_ind_pi):
                gpar = _construct_gpar(self, vs, self.m, pi + 1)
                if not fix:
                    # The whole chain of layers 0..pi from the raw inputs.
                    return -gpar.logpdf(self.x, y_cached, None)
                return -gpar.logpdf(
                    x_pi,
                    y_cached,
                    None,
                    only_last_layer=True,
                    outputs=[pi],
                    x_ind=x_ind_pi,
                )

            f0, f, it = minimise_l_bfgs_b(
                objective,
                self.vs,
                names=[f"{pi}/*"] if fix else [f"{i}/*" for i in range(pi + 1)],
                iters=iters,
                gtol=gtol,
                memory_size=memory_size,
                restarts=restarts,
                restart_scale=restart_scale,
                generator=generator,
                normals=None if normals is None else normals[pi],
            )
            nll0.append(f0)
            nll.append(f)
            its.append(it)
            if fix and pi < self.p - 1:
                # Layer pi is fixed from here on: append its posterior means
                # (data rows and inducing inputs) for layer pi + 1.
                with torch.no_grad():
                    gpar = _construct_gpar(self, self.vs, self.m, pi + 2)
                    x_pi, x_ind_pi = gpar.logpdf(
                        x_pi,
                        y_cached,
                        None,
                        only_last_layer=True,
                        outputs=[pi],
                        x_ind=x_ind_pi,
                        return_inputs=True,
                    )
        return nll0, nll, its

    def _normals(self, normals, shape, generator, what):
        """Caller-supplied standard normals of ``shape``, uploaded, or fresh
        draws from ``generator`` (default: the device's generator of
        ``utils.rng``)."""
        if normals is None:
            gen = default_generator(self.device) if generator is None else generator
            return torch.randn(shape, generator=gen, dtype=self.dtype, device=self.device)
        normals = self._upload(normals)
        if tuple(normals.shape) != shape:
            raise ValueError(f"{what} has shape {tuple(normals.shape)}; expected {shape}")
        return normals

    def _sample_batch(self, x, w, num_samples, latent, normals, noise_normals, generator,
                      p_prior=None):
        """Model-space draws (num_samples, n, p) at the inputs ``x``: from the
        posterior, or with ``p_prior`` outputs from the prior.  The test rows
        are padded to their bucket and masked out of every covariance; the
        padded draws are sliced off.  ``normals`` (p, num_samples, n) are the
        draws' standard normals and ``noise_normals`` (same shape) those of
        the noise that a latent draw feeds forward (``replace=False``); each
        defaults to draws from ``generator``."""
        from .fused import (
            build_scan_prior_plan, factor_slices, make_scan_ancestral_tail, make_scan_cached_tail,
            make_scan_predict_tail, make_scan_prior_tail, posterior_factor_layers,
            resolve_sample_chunk,
        )

        posterior = p_prior is None
        x_np = _uprank_np(x, self._np_dtype)
        nt, m_in = x_np.shape
        p = self.p if posterior else p_prior
        if w is None:
            w_np = np.ones((nt, p), self._np_dtype)
        else:
            w_np = self._permute_outputs(_uprank_np(w, self._np_dtype), strict=posterior)
        shape = (p, num_samples, nt)
        normals = self._normals(normals, shape, generator, "normals")
        if latent and not self.replace:
            noise_normals = self._normals(noise_normals, shape, generator, "noise_normals")
        else:
            noise_normals = None  # the noise of a draw that feeds forward: none here
        pad = bucket_rows(nt) - nt
        x_t = self._upload(np.pad(x_np, ((0, pad), (0, 0))))
        w_t = self._upload(np.pad(w_np, ((0, pad), (0, 0)), constant_values=1.0).T)
        mt = self._upload(np.arange(nt + pad) < nt)
        normals = torch.nn.functional.pad(normals, (0, pad))
        if noise_normals is not None:
            noise_normals = torch.nn.functional.pad(noise_normals, (0, pad))
        chunk = resolve_sample_chunk(config.predict_sample_chunk, num_samples, nt + pad,
                                     self.dtype, config.predict_memory_budget)
        if not posterior:
            gpar = _construct_gpar(self, self.vs, m_in, p)
            for layer in gpar.layers:
                layer()
            names = self.vs.select(None)
            plan = build_scan_prior_plan(self, m_in, p, names, self._np_dtype)
            tail = make_scan_prior_tail(plan, latent, chunk)
            batch = tail(self.vs.latent_vector(names), x_t, w_t, normals, noise_normals, mt)
            return batch[:, :nt]
        self._ensure_vars(p)
        names = self.vs.select(None)
        plan = self._scan_fit_plan(names)
        x_pad, rows = self._bucket_fit_inputs(plan)
        z = self.vs.latent_vector(names)
        cached = self._factor_cache_eligible(plan)
        if self.replace:
            if cached:
                tail = make_scan_cached_tail(plan, latent, rows_traced=True)
                factors = self._posterior_factors(plan, z)
                return tail(z, factors, x_t, w_t, normals, rows, mt)[0][:, :nt]
            tail = make_scan_predict_tail(plan, self.x_ind, latent, rows_traced=True)
            return tail(z, x_pad, x_t, w_t, normals, rows, mt)[0][:, :nt]
        if cached:
            factors = factor_slices(self._posterior_factors(plan, z))
        else:
            factors = posterior_factor_layers(plan, self.x_ind, rows_traced=True)(z, x_pad, rows)
        tail = make_scan_ancestral_tail(plan, latent, chunk, rows_traced=True)
        return tail(z, factors, x_t, w_t, normals, noise_normals, rows, mt)[:, :nt]

    def predict(
        self,
        x,
        w=None,
        num_samples=100,
        latent=False,
        credible_bounds=False,
        normals=None,
        noise_normals=None,
        generator=None,
    ):
        """Monte-Carlo predictive means, and with ``credible_bounds`` the
        2.5 / 97.5 percentiles, at new inputs
        (``gpar/regression.py:566-597``); NumPy arrays of shape (n, p), in
        the original column order (``w``, too, is in that order).

        ``normals`` (p, num_samples, n) supplies the standard normals of
        the draws, and ``noise_normals`` (same shape) those of the noise a
        latent draw feeds forward under ``replace=False``; otherwise they
        come from ``generator`` (default: the device's generator of
        ``utils.rng``)."""
        if not self.is_conditioned:
            raise RuntimeError(
                "Cannot sample from the posterior: no data has been "
                "conditioned on yet (call fit() or condition() first)."
            )
        with torch.no_grad():
            batch = self._sample_batch(x, w, num_samples, latent, normals, noise_normals,
                                       generator)
            batch = self._undo_transforms(batch)
            out = [torch.mean(batch, dim=0)]
            if credible_bounds:
                q = torch.tensor([0.025, 0.975], dtype=self.dtype, device=self.device)
                lo, hi = torch.quantile(batch, q, dim=0, interpolation="linear")
                out += [lo, hi]
        out = tuple(self._unpermute_outputs(a.cpu().numpy()) for a in out)
        return out if credible_bounds else out[0]

    def sample(
        self,
        x,
        w=None,
        p=None,
        posterior=False,
        num_samples=1,
        latent=False,
        normals=None,
        noise_normals=None,
        generator=None,
    ):
        """Samples from the prior, or from the posterior with ``posterior``
        (``gpar/regression.py:508-564``): one (n, p) array, or a list of
        them when ``num_samples > 1``.  The prior needs ``p``, the number of
        outputs.  ``normals``, ``noise_normals`` and ``generator`` as in
        :meth:`predict`.  Under a greedy ordering the columns are the
        original ones, except those of a prior sample of another width than
        the fitted one, which stay in layer order."""
        if posterior and not self.is_conditioned:
            raise RuntimeError(
                "Cannot sample from the posterior: no data has been "
                "conditioned on yet (call fit() or condition() first)."
            )
        if not posterior and p is None:
            raise ValueError("Prior sampling needs `p`, the number of outputs to draw.")
        with torch.no_grad():
            batch = self._sample_batch(x, w, num_samples, latent, normals, noise_normals,
                                       generator, p_prior=None if posterior else p)
            batch = self._undo_transforms(batch).cpu().numpy()
        # Layer order -> original columns (a prior sample of another chain
        # length stays in layer order).
        samples = list(self._unpermute_outputs(batch, strict=posterior))
        return samples[0] if num_samples == 1 else samples

    def logpdf(self, x, y, w=None, sample_missing=False, posterior=False, normals=None,
               generator=None):
        """Log-density of observations (``gpar/regression.py:461-506``):
        under the prior, or with ``posterior`` under the posterior given the
        conditioned data.  A Python float, or a detached 0-d tensor in the
        estimator's dtype on its device when ``x`` or ``y`` is a tensor (as
        the JAX package returns a device scalar for JAX inputs).  Tensor
        inputs, on any device and requiring grad or not, are read as
        data.  ``y`` may hold NaNs
        (missing outputs) and ``w`` weights the noise (default ones); both
        are in the original column order and, under a greedy ordering,
        must have the fitted width.

        ``y`` is transformed by ``transform_y`` and then, when the model
        normalises and was conditioned, by the conditioned statistics: with
        ``compat=True`` (the default) un-normalised, as the reference does
        (``gpar/regression.py:483``), with ``compat=False`` normalised as in
        :meth:`condition`.  Neither adds a Jacobian term for the transforms;
        the value is the density of the transformed data.

        The prior scores through the scan-fused chain
        (``fused.make_scan_logpdf_body``) on rows padded to their bucket,
        and the posterior through ``fused.make_scan_posterior_logpdf_tail``
        when the scored width equals the conditioned one.  Otherwise, and
        with ``sample_missing``, the GP core scores: the conditioned GPAR
        ``GPAR | (x, y, w)`` and ``GPAR.logpdf``.  ``sample_missing`` fills
        the missing outputs that feed later layers with one posterior draw
        per layer; ``normals`` gives those draws' standard normals, one
        vector per drawing layer in order, else they come from
        ``generator`` (default: the device's generator of ``utils.rng``)."""
        if posterior and not self.is_conditioned:
            raise RuntimeError(
                "Cannot evaluate the posterior logpdf: no data has been "
                "conditioned on yet (call fit() or condition() first)."
            )
        tensors = isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor)
        x_np, y_np, w_np = self._score_data(x, y, w, posterior)
        value = None
        if not sample_missing and x_np.shape[0] > 0:
            value = self._logpdf_scan(x_np, y_np, w_np, posterior)
        if value is None:
            value = self._logpdf_core(x_np, y_np, w_np, posterior, sample_missing, normals,
                                      generator)
        if tensors:
            return torch.as_tensor(value, dtype=self.dtype, device=self.device).detach()
        return float(value)

    def _score_data(self, x, y, w, posterior):
        """Scored data on the host in layer order, ``y`` transformed and
        (un)normalised as :meth:`logpdf` says, weights defaulting to ones;
        and every layer's
        variables for the scored width (the conditioned one for
        ``posterior``)."""
        x_np = _uprank_np(x, self._np_dtype)
        y_np = self._permute_outputs(_uprank_np(y, self._np_dtype))
        w_np = None if w is None else self._permute_outputs(_uprank_np(w, self._np_dtype))
        y_np = np.asarray(self._transform_y(torch.as_tensor(y_np)), dtype=self._np_dtype)
        if self.normalise_y and self._means is not None:
            if self.compat:
                y_np = y_np * self._stds + self._means
            else:
                y_np = (y_np - self._means) / self._stds
        if w_np is None:
            w_np = np.ones(y_np.shape, self._np_dtype)
        if posterior:
            self._ensure_vars(self.p)
        else:
            self._ensure_vars(y_np.shape[1], x_np.shape[1])
        return x_np, y_np, w_np

    def _logpdf_core(self, x_np, y_np, w_np, posterior, sample_missing=False, normals=None,
                     generator=None):
        """The GP core's score of prepared data (:meth:`_score_data`): the
        conditioned GPAR and ``GPAR.logpdf``, a Python float."""
        if sample_missing and normals is None and generator is None:
            generator = default_generator(self.device)
        with torch.no_grad():
            gpar = _construct_gpar(self, self.vs, x_np.shape[1], y_np.shape[1])
            if posterior:
                gpar = gpar | (self.x, self._y_cache, None)
            return float(gpar.logpdf(self._upload(x_np), y_np, w_np, sample_missing=sample_missing,
                                     normals=normals, generator=generator))

    def _bucket_score_inputs(self, plan, x_np, y_np, w_np):
        """``(x_pad, rows)`` of scored data: padded to its row bucket, and
        its per-layer row arrays derived on the device (uncached, unlike
        :meth:`_bucket_fit_inputs`)."""
        from .fused import device_bucket_inputs

        return device_bucket_inputs(x_np, y_np, w_np, n_b=bucket_rows(plan.n),
                                    impute=bool(self.impute), device=self.device)

    def _logpdf_scan(self, x_np, y_np, w_np, posterior):
        """The scan-fused score of prepared data (:meth:`_score_data`),
        bucketed, or None where the posterior's scored width differs from
        the conditioned one (its factors are the conditioned chain's)."""
        from .fused import (
            build_scan_data_plan, factor_slices, make_scan_logpdf_body,
            make_scan_posterior_logpdf_tail, posterior_factor_layers,
        )

        names = self.vs.select(None)
        z = self.vs.latent_vector(names)
        plan = build_scan_data_plan(self, x_np, y_np, w_np, names)
        if posterior and (plan.p != self.p or plan.m != self.m):
            return None
        x_pad, rows = self._bucket_score_inputs(plan, x_np, y_np, w_np)
        if not posterior:
            return make_scan_logpdf_body(plan, self.x_ind, rows_traced=True)(z, x_pad, rows)
        plan_tr = self._scan_fit_plan(names)
        x_tr, rows_tr = self._bucket_fit_inputs(plan_tr)
        if self._factor_cache_eligible(plan_tr):
            factors = factor_slices(self._posterior_factors(plan_tr, z))
        else:
            factors = posterior_factor_layers(plan_tr, self.x_ind, rows_traced=True)(z, x_tr,
                                                                                     rows_tr)
        tail = make_scan_posterior_logpdf_tail(plan, self.x_ind, rows_traced=True)
        return tail(z, factors, x_pad, rows, None if plan.sparse else rows_tr["obs_mask"])

    def _factor_stack_fits(self, plan):
        """Whether the stacked posterior factors are small enough to keep
        (``gpar_tpu/models/regressor.py:2922-2936``), reckoned at the row
        bucket the factors are computed at: a sparse stack (p M^2) always
        is; a dense one holds p * rows * (rows + W + 1) elements and must
        fit ``config.posterior_cache_max_bytes``."""
        if plan.sparse:
            return True
        n_b = bucket_rows(plan.n)
        nbytes = plan.p * n_b * (n_b + plan.W + 1) * self.dtype.itemsize
        return nbytes <= config.posterior_cache_max_bytes

    def _factor_cache_eligible(self, plan):
        """Whether the posterior-factor cache engages
        (``gpar_tpu/models/regressor.py:2906-2920``): on with
        ``config.posterior_cache`` and a stack that fits."""
        return config.posterior_cache and self._factor_stack_fits(plan)

    def _posterior_factors(self, plan, z):
        """The conditioned data's per-layer posterior factors at the latents
        ``z``, stacked (``fused.make_scan_posterior_factors`` at the row
        bucket), computed at most once per (latents, data): one slot keyed
        on the row bucket, the width, dtype, device, the latents' bytes and
        the jitter settings the factorisations used
        (``gpar_tpu/models/regressor.py:2938-2991``, whose key lacks the
        bucket).  :meth:`condition` (and so :meth:`fit`),
        :meth:`load_latents`, a reordering and a checkpoint load drop the
        slot."""
        from .fused import make_scan_posterior_factors

        key = (bucket_rows(plan.n), self.p, str(self.dtype), str(self.device),
               z.detach().cpu().numpy().tobytes(), config.epsilon, config.epsilon_f32,
               tuple(config.cholesky_retry_factors))
        if self._factor_cache is not None and self._factor_cache[0] == key:
            return self._factor_cache[1]
        self._factor_cache = None  # the old stack goes before the new one is made
        x_pad, rows = self._bucket_fit_inputs(plan)
        factors = make_scan_posterior_factors(plan, self.x_ind, rows_traced=True)(z, x_pad, rows)
        self._factor_cache = (key, factors)
        return factors

    def precompute(self):
        """Compute and keep the per-layer posterior factors of the current
        latents and conditioned data, so that the next ``predict``,
        ``sample(posterior=True)`` and posterior ``logpdf`` run only the
        test-point work (``gpar_tpu/models/regressor.py:2993-3025``; the
        reference conditions anew in every call, ``gpar/regression.py:
        547``).  Both ``replace`` modes consume the factors.  Returns True
        when the factors are cached (computed now or before), False where
        the cache does not engage: ``config.posterior_cache`` off, or a
        dense stack over ``config.posterior_cache_max_bytes`` at the row
        bucket."""
        if not self.is_conditioned:
            raise RuntimeError(
                "Cannot precompute posterior factors: no data has been "
                "conditioned on yet (call fit() or condition() first)."
            )
        self._ensure_vars(self.p)
        names = self.vs.select(None)
        plan = self._scan_fit_plan(names)
        if not self._factor_cache_eligible(plan):
            return False
        self._posterior_factors(plan, self.vs.latent_vector(names))
        return True

    def warmup(self, n, p, m=1, n_test=None, num_samples=100, latent=False, credible_bounds=False,
               paths=None, **fit_kwargs):
        """Prepare the card for requests of a shape before real data
        arrives (``gpar_tpu/models/regressor.py:3066-3249``): on a CUDA
        device load the Gram kernels (building ``csrc/gram.cu`` on first
        use, ``ops/_build.py``), then run the real ``fit`` / ``logpdf`` /
        ``predict`` / ``fit_predict`` of a scratch estimator with this
        one's configuration (the same transform objects) on synthetic,
        fully observed data of ``n`` rows, ``m`` inputs and ``p`` outputs.
        The scan step's CUDA graphs of the row bucket enter the shared
        cache of ``models/graphs.py``, so a later fit whose rows fall in
        the same bucket, with the same optimiser options, captures nothing.
        This estimator is left untouched.

        ``paths`` is a subset of ``("fit", "predict", "fit_predict",
        "logpdf")``, by default ``("fit", "logpdf")`` without ``n_test``
        and all four with it; ``fit_kwargs`` are the production fit's
        options (``iters=``, ``gtol=``, ``memory_size=``, ``restarts=``,
        ``restart_scale=``, ``fused=``, ``fix=``, ``cuda_graphs=``), part of
        the graph cache's key.  A greedy fit cannot be warmed: its order is
        data-dependent.

        Returns ``{"buckets": {"rows": ..., "test_rows": ...}, "seconds":
        {path: wall-clock}}``.  Unlike the JAX package's, there is no
        ``samples`` bucket (the port's tails run at the caller's sample
        count) and no ``shape_buckets`` switch (rows are always
        bucketed)."""
        if fit_kwargs.pop("greedy", False):
            raise ValueError(
                "warmup() cannot pre-compile a greedy fit: the output "
                "ordering is data-dependent and is baked into the "
                "programs' gather maps."
            )
        fix = fit_kwargs.pop("fix", True)
        if paths is None:
            paths = ("fit", "logpdf") if n_test is None else (
                "fit", "predict", "fit_predict", "logpdf")
        unknown = set(paths) - {"fit", "predict", "fit_predict", "logpdf"}
        if unknown:
            raise ValueError(f"Unknown warmup() paths: {sorted(unknown)}")
        if ("predict" in paths or "fit_predict" in paths) and n_test is None:
            raise ValueError("Warming the serving programs needs n_test=.")

        if self.device.type == "cuda":
            from ..ops._build import load_library

            load_library()
        scratch = GPARRegressor(
            replace=self.replace, impute=self.impute, x_ind=self.x_ind,
            normalise_y=self.normalise_y, transform_y=(self._transform_y, self._untransform_y),
            compat=self.compat, device=self.device, dtype=self.dtype, **self.model_config,
        )
        # Synthetic fully observed data, through the inverse transform so
        # that condition()'s forward transform recovers a well-conditioned
        # standard-normal model-space dataset (JAX's, number for number).
        rng = np.random.default_rng(20)
        x_d = rng.uniform(size=(n, m))
        z = 0.5 * rng.standard_normal((n, p))
        y_d = np.asarray(_host(self._untransform_y(torch.as_tensor(z))), dtype=float)
        if not np.isfinite(y_d).all():
            raise ValueError(
                "warmup()'s synthetic data is non-finite through this "
                "estimator's inverse transform_y; run a dummy fit with "
                "representative data instead."
            )
        x_t = rng.uniform(size=(n_test, m)) if n_test is not None else None

        fp_keys = ("iters", "gtol", "memory_size", "restarts", "restart_scale", "fused",
                   "cuda_graphs")
        fp_kwargs = {k: v for k, v in fit_kwargs.items() if k in fp_keys}
        seconds = {}
        if "fit" in paths or "predict" in paths:
            t0 = time.perf_counter()
            scratch.fit(x_d, y_d, fix=fix, **fit_kwargs)
            seconds["fit"] = time.perf_counter() - t0
        if "logpdf" in paths:
            if not scratch.is_conditioned:
                scratch.condition(x_d, y_d)
            t0 = time.perf_counter()
            scratch.logpdf(x_d, y_d)
            if n_test is not None:
                z_t = 0.5 * rng.standard_normal((n_test, p))
                y_t = np.asarray(_host(self._untransform_y(torch.as_tensor(z_t))), dtype=float)
                scratch.logpdf(x_t, y_t)
                scratch.logpdf(x_t, y_t, posterior=True)
            else:
                scratch.logpdf(x_d, y_d, posterior=True)
            seconds["logpdf"] = time.perf_counter() - t0
        if "predict" in paths:
            t0 = time.perf_counter()
            scratch.predict(x_t, num_samples=num_samples, latent=latent,
                            credible_bounds=credible_bounds)
            seconds["predict"] = time.perf_counter() - t0
        if "fit_predict" in paths:
            t0 = time.perf_counter()
            scratch.fit_predict(x_d, y_d, x_test=x_t, num_samples=num_samples, latent=latent,
                                credible_bounds=credible_bounds, **fp_kwargs)
            seconds["fit_predict"] = time.perf_counter() - t0

        buckets = {"rows": bucket_rows(n)}
        if n_test is not None:
            buckets["test_rows"] = bucket_rows(n_test)
        return {"buckets": buckets, "seconds": seconds}

    def fit_predict(
        self,
        x,
        y,
        x_test=None,
        w=None,
        w_test=None,
        num_samples=100,
        latent=False,
        credible_bounds=False,
        normals=None,
        noise_normals=None,
        generator=None,
        **fit_kw,
    ):
        """``fit(x, y, w, **fit_kw)`` followed by ``predict(x_test, w_test,
        ...)``; ``x_test`` defaults to the training inputs.  ``generator``
        serves both: the fit's restart perturbations (``restarts > 1``)
        are drawn first, then the predictive's normals."""
        self.fit(x, y, w, generator=generator, **fit_kw)
        return self.predict(
            self._x_np if x_test is None else x_test,
            w_test,
            num_samples=num_samples,
            latent=latent,
            credible_bounds=credible_bounds,
            normals=normals,
            noise_normals=noise_normals,
            generator=generator,
        )
