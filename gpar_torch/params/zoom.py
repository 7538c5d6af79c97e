# Derived from optax 0.2.6 (``optax/_src/transform.py``: ``scale_by_lbfgs``,
# ``_precondition_by_lbfgs``; ``optax/_src/linesearch.py``:
# ``zoom_linesearch``, ``scale_by_zoom_linesearch``; ``optax/_src/utils.py``:
# ``value_and_grad_from_state``; ``optax/_src/alias.py``: ``lbfgs``).
# Copyright 2024 DeepMind Technologies Limited. All Rights Reserved.
# Licensed under the Apache License, Version 2.0 (the "License"); you may
# not use this file except in compliance with the License.  You may obtain a
# copy of the License at http://www.apache.org/licenses/LICENSE-2.0.  Unless
# required by applicable law or agreed to in writing, software distributed
# under the License is distributed on an "AS IS" BASIS, WITHOUT WARRANTIES OR
# CONDITIONS OF ANY KIND, either express or implied.  See the License for the
# specific language governing permissions and limitations under the License.
"""optax's ``lbfgs(memory_size=m)`` on torch tensors: the optimiser of the
traced fit (``minimise_l_bfgs_b(trace=True)``, the JAX package's
``gpar_tpu/params/optim.py:143-176``).

It is ``chain(scale_by_lbfgs(m), scale(-1.0),
scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one"))`` with optax's defaults: ``slope_rtol`` 1e-4,
``curv_rtol`` 0.9, ``approx_dec_rtol`` 1e-6, ``increase_factor`` 2,
``stepsize_precision`` 1e-5, no largest step, ``tol`` 0.

- :func:`lbfgs_direction` is ``scale_by_lbfgs`` followed by ``scale(-1)``:
  the memory is updated with the new point first (its weight 0 where
  ``<dg, dz> = 0``, the differences zeroed at ``count = 0``), then the
  two-loop recursion runs over the ring buffer from slot ``count % m``,
  with the identity scaled by ``min(1, 1/|g|)`` at ``count = 0`` and by
  ``<dg, dz> / |dg|^2`` after.
- :func:`zoom_linesearch` is optax's zoom: the interval search, the zoom by
  cubic, quadratic or bisection steps, the approximate (Hager-Zhang)
  decrease, and the safe step when the search fails, which takes the best
  step of sufficient decrease seen, or that step also when the last trial
  left the objective's domain (a non-finite value).
- :func:`lbfgs_update` chains them; :func:`value_and_grad_from_state`
  reuses the value and gradient the line search found at the accepted step
  (so an iteration costs one evaluation per line-search step and none
  besides), and evaluates afresh only where the state's value is not
  finite.

Every ``jnp.where`` of optax is a ``torch.where`` on the device: a value
that can be NaN never reaches a Python ``if``.  The host reads one
three-flag tensor per line-search step (``interval_found``, ``done``,
``failed``: optax's ``while_loop`` condition and its branch); ``stats``
counts those reads (``host_syncs``), each the span ``gpar.fit.read``.
"""

from typing import NamedTuple

import torch

from ..utils.spans import span

__all__ = [
    "LBFGSMemory",
    "ZoomState",
    "LBFGSState",
    "MAX_LINESEARCH_STEPS",
    "lbfgs_init",
    "lbfgs_direction",
    "zoom_linesearch",
    "lbfgs_update",
    "value_and_grad_from_state",
]

#: ``optax.lbfgs``'s ``max_linesearch_steps``.
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5  # stepsize_precision
TOL = 0.0


class LBFGSMemory(NamedTuple):
    """``ScaleByLBFGSState``: ``count`` on the host (it only counts)."""

    count: int
    params: torch.Tensor  # (d,)
    updates: torch.Tensor  # the last gradient (d,)
    diff_params: torch.Tensor  # (m, d)
    diff_updates: torch.Tensor  # (m, d)
    weights: torch.Tensor  # (m,)


class ZoomState(NamedTuple):
    """``ZoomLinesearchState``: scalars and flags are 0-d tensors on the
    device, ``count`` on the host."""

    count: int
    params: torch.Tensor
    updates: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


class LBFGSState(NamedTuple):
    """The chain's state: the memory and what the driver reads of
    ``ScaleByZoomLinesearchState`` (``value``, ``grad``;
    ``num_linesearch_steps`` of its info)."""

    memory: LBFGSMemory
    value: torch.Tensor
    grad: torch.Tensor
    num_linesearch_steps: int


def _scalar(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def lbfgs_init(z, memory_size=10):
    """``optax.lbfgs(memory_size).init(z)``."""
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")
    z = z.detach()
    zeros = torch.zeros((memory_size,) + tuple(z.shape), dtype=z.dtype, device=z.device)
    memory = LBFGSMemory(0, torch.zeros_like(z), torch.zeros_like(z), zeros, zeros.clone(),
                         torch.zeros(memory_size, dtype=z.dtype, device=z.device))
    return LBFGSState(memory, _scalar(float("inf"), z), torch.zeros_like(z), 0)


def _precondition(updates, diff_params, diff_updates, weights, identity_scale, memory_idx):
    """``_precondition_by_lbfgs``: the two-loop recursion over the slots
    ``(memory_idx + i) % m``, newest first, then oldest first."""
    m = weights.shape[0]
    indices = [(memory_idx + i) % m for i in range(m)]
    vec, alphas = updates, [None] * m
    for i in reversed(range(m)):
        idx = indices[i]
        alpha = weights[idx] * torch.dot(diff_params[idx], vec)
        vec = vec + (-alpha) * diff_updates[idx]
        alphas[i] = alpha
    vec = identity_scale * vec
    for i in range(m):
        idx = indices[i]
        beta = weights[idx] * torch.dot(diff_updates[idx], vec)
        vec = vec + (alphas[i] - beta) * diff_params[idx]
    return vec


def lbfgs_direction(grad, memory, z):
    """``scale_by_lbfgs`` then ``scale(-1.0)``: the update direction at
    ``z`` with gradient ``grad``, and the new memory."""
    m = memory.weights.shape[0]
    memory_idx = memory.count % m
    prev_memory_idx = (memory.count - 1) % m
    diff_params = z - memory.params
    diff_updates = grad - memory.updates
    vdot = torch.dot(diff_updates, diff_params)
    weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
    if memory.count == 0:
        # optax's ``jnp.where(state.count > 0, x, 0)``: no difference yet.
        diff_params, diff_updates = torch.zeros_like(z), torch.zeros_like(z)
        weight = torch.zeros_like(weight)
    dp_mem, du_mem, w_mem = (memory.diff_params.clone(), memory.diff_updates.clone(),
                             memory.weights.clone())
    dp_mem[prev_memory_idx] = diff_params
    du_mem[prev_memory_idx] = diff_updates
    w_mem[prev_memory_idx] = weight

    if memory.count > 0:
        numerator = torch.dot(diff_updates, diff_params)
        denominator = torch.sum(diff_updates * diff_updates)
        identity_scale = torch.where(denominator > 0.0, numerator / denominator,
                                     torch.ones_like(numerator))
    else:
        # The capped reciprocal of the gradient's norm (optax's note).
        identity_scale = torch.clamp_max(1.0 / torch.sqrt(torch.sum(grad * grad)), 1.0)
    precond = _precondition(grad, dp_mem, du_mem, w_mem, identity_scale, memory_idx)
    new = LBFGSMemory(memory.count + 1, z, grad, dp_mem, du_mem, w_mem)
    return -1.0 * precond, new


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope ``fpa`` at a; NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc**2 * v0 + (-(db**2)) * v1) / denom
    B = ((-(dc**3)) * v0 + db**3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope ``fpa`` at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


def _nan_to_inf(e):
    return torch.where(torch.isnan(e), torch.full_like(e, float("inf")), e)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    """Armijo's decrease, or Hager and Zhang's approximate decrease where
    the value is within ``approx_dec_rtol |f0|`` of the start; 0 where it
    holds, inf where it is NaN."""
    decrease_error = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    approx = torch.maximum(approx, delta_values)
    decrease_error = torch.minimum(approx, decrease_error)
    return _nan_to_inf(torch.clamp_min(decrease_error, 0.0))


def _curvature_error(slope_step, slope_init):
    e = torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init)
    return _nan_to_inf(torch.clamp_min(e, 0.0))


def _where(cond, a, b):
    return [torch.where(cond, u, v) for u, v in zip(a, b)]


def _on_line(value_and_grad, params, stepsize, updates):
    value, grad = value_and_grad(params + stepsize * updates)
    return value, grad, torch.dot(grad, updates)


def _init(updates, params, value, grad):
    """``zoom_linesearch``'s ``init_fn`` with ``initial_guess_strategy="one"``."""
    slope = torch.dot(updates, grad)
    zero, inf = _scalar(0.0, value), _scalar(float("inf"), value)
    false = torch.zeros((), dtype=torch.bool, device=value.device)
    return ZoomState(
        count=0, params=params, updates=updates, stepsize=zero, value=value, grad=grad,
        slope=slope, value_init=value, slope_init=slope, decrease_error=inf,
        interval_found=false, done=false, failed=false, low=zero, value_low=value, slope_low=slope, high=zero, value_high=value, slope_high=slope, cubic_ref=zero,
        value_cubic_ref=value, safe_stepsize=zero, safe_value=value, safe_grad=grad)


def _search_interval(st, value_and_grad, max_steps):
    """Algorithm 3.5 of Nocedal and Wright (``_search_interval``)."""
    if st.count == 0:
        new_stepsize = torch.ones_like(st.stepsize)  # the guess "one"
    else:
        new_stepsize = INCREASE_FACTOR * st.stepsize
    value, grad, slope = _on_line(value_and_grad, st.params, new_stepsize, st.updates)
    dec = _decrease_error(new_stepsize, value, slope, st.value_init, st.slope_init)
    error = torch.maximum(dec, _curvature_error(slope, st.slope_init))
    safe_stepsize, safe_value, safe_grad = _where(
        dec <= TOL, [new_stepsize, value, grad], [st.safe_stepsize, st.safe_value, st.safe_grad])
    set_high_to_new = dec > 0.0
    if st.count > 0:
        set_high_to_new = set_high_to_new | (value >= st.value)
    set_low_to_new = (slope >= 0.0) & ~set_high_to_new
    low, value_low, slope_low, high, value_high, slope_high = _where(
        set_low_to_new,
        [new_stepsize, value, slope, st.stepsize, st.value, st.slope],
        [st.stepsize, st.value, st.slope, new_stepsize, value, slope])
    done = error <= TOL
    interval_found = set_high_to_new | set_low_to_new | done
    failed = ~done if st.count + 1 >= max_steps else torch.zeros_like(done)
    return st._replace(
        count=st.count + 1, stepsize=new_stepsize, value=value, grad=grad, slope=slope,
        decrease_error=dec, interval_found=interval_found,
        done=done, failed=failed, low=low, value_low=value_low, slope_low=slope_low, high=high,
        value_high=value_high, slope_high=slope_high, cubic_ref=low, value_cubic_ref=value_low,
        safe_stepsize=safe_stepsize, safe_value=safe_value, safe_grad=safe_grad)


def _zoom_into_interval(st, value_and_grad, max_steps):
    """Algorithm 3.6 of Nocedal and Wright (``_zoom_into_interval``)."""
    low, value_low, slope_low = st.low, st.value_low, st.slope_low
    high, value_high, slope_high = st.high, st.value_high, st.slope_high
    delta = torch.abs(high - low)
    left = torch.minimum(high, low)
    right = torch.maximum(high, low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    too_small_int = delta <= INTERVAL_THRESHOLD

    middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high, st.cubic_ref,
                             st.value_cubic_ref)
    use_cubic = (middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk)
    middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
    use_quad = ~use_cubic & (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk)
    use_bisection = ~use_cubic & ~use_quad
    middle = torch.where(use_cubic, middle_cubic, st.cubic_ref)
    middle = torch.where(use_quad, middle_quad, middle)
    middle = torch.where(use_bisection, (low + high) / 2.0, middle)

    value, grad, slope = _on_line(value_and_grad, st.params, middle, st.updates)
    dec = _decrease_error(middle, value, slope, st.value_init, st.slope_init)
    error = torch.maximum(dec, _curvature_error(slope, st.slope_init))
    update_safe = (dec <= TOL) & (value < st.safe_value)
    safe_stepsize, safe_value, safe_grad = _where(
        update_safe, [middle, value, grad], [st.safe_stepsize, st.safe_value, st.safe_grad])
    done = error <= TOL
    set_high_to_middle = (dec > 0.0) | (value >= value_low)
    set_high_to_low = (slope * (high - low) >= 0.0) & ~set_high_to_middle
    set_low_to_middle = ~set_high_to_middle
    new_high = _where(set_high_to_middle, [middle, value, slope], [high, value_high, slope_high])
    new_high = _where(set_high_to_low, [low, value_low, slope_low], new_high)
    new_low = _where(set_low_to_middle, [middle, value, slope], [low, value_low, slope_low])
    cubic_ref, value_cubic_ref = _where(set_high_to_middle | set_high_to_low,
                                        [high, value_high], [low, value_low])
    if st.count + 1 >= max_steps:
        failed = ~done
    else:
        failed = too_small_int & (safe_stepsize > 0.0) & ~done
    return st._replace(
        count=st.count + 1, stepsize=middle, value=value, grad=grad, slope=slope,
        decrease_error=dec, done=done, failed=failed,
        low=new_low[0], value_low=new_low[1], slope_low=new_low[2], high=new_high[0],
        value_high=new_high[1], slope_high=new_high[2], cubic_ref=cubic_ref,
        value_cubic_ref=value_cubic_ref, safe_stepsize=safe_stepsize, safe_value=safe_value,
        safe_grad=safe_grad)


def _try_safe_step(st):
    """The step of sufficient decrease found, if any, else the last trial;
    outside the objective's domain (an infinite decrease error) the safe
    step, even at stepsize 0."""
    outside_domain = torch.isinf(st.decrease_error)
    stepsize, value, grad = _where((st.safe_stepsize > 0.0) | outside_domain,
                                   [st.safe_stepsize, st.safe_value, st.safe_grad],
                                   [st.stepsize, st.value, st.grad])
    return st._replace(stepsize=stepsize, value=value, grad=grad)


def _read_flags(st, stats):
    stats["host_syncs"] += 1
    with span("gpar.fit.read"):
        flags = torch.stack([st.interval_found, st.done, st.failed]).tolist()
    return tuple(bool(f) for f in flags)


def zoom_linesearch(updates, params, value, grad, value_and_grad,
                    max_steps=MAX_LINESEARCH_STEPS, stats=None):
    """optax's zoom line search along ``updates`` from ``params`` (value
    ``value``, gradient ``grad``): its ``while_loop`` of steps, driven from
    the host with one read of the flags after each step.  Returns the final
    :class:`ZoomState` (``stepsize``, ``value``, ``grad``, ``count``)."""
    stats = {"host_syncs": 0} if stats is None else stats
    st = _init(updates, params, value, grad)
    interval_found = done = failed = False
    while not (done or failed):
        step = _zoom_into_interval if interval_found else _search_interval
        st = step(st, value_and_grad, max_steps)
        interval_found, done, failed = _read_flags(st, stats)
        if failed:
            st = _try_safe_step(st)
    return st


def lbfgs_update(grad, state, z, value, value_and_grad, stats=None):
    """``optax.lbfgs(m).update(grad, state, z, value=value, grad=grad,
    value_fn=...)``: returns ``(updates, state)``; ``z + updates`` is the
    next iterate (``optax.apply_updates``), at which the state's ``value``
    and ``grad`` were evaluated."""
    direction, memory = lbfgs_direction(grad, state.memory, z)
    ls = zoom_linesearch(direction, z, value, grad, value_and_grad, stats=stats)
    return ls.stepsize * direction, LBFGSState(memory, ls.value, ls.grad, ls.count)


def value_and_grad_from_state(value_and_grad, z, state, value_is_finite):
    """optax's ``value_and_grad_from_state``: the state's value and
    gradient, or a fresh evaluation at ``z`` where the state's value is not
    finite.  ``value_is_finite`` is the host's reading of the state's value
    (``False`` for a fresh state, whose value is inf)."""
    if value_is_finite:
        return state.value, state.grad
    return value_and_grad(z)

