"""CUDA graphs of the scan-fused layer step and of the predictive tails.

The port's counterpart of ``jax.jit`` of the scan body and of the JAX
package's cross-instance program cache (``regressor._shared_jit``,
``gpar_tpu/models/regressor.py:1404-1432``): each body of a
:class:`~gpar_torch.models.fused.ScanStep` is captured once with
``torch.cuda.graph`` per key and replayed for every layer, every L-BFGS
iteration and every later fit with the same key, by any estimator.  The
key covers the plan's fingerprint (model structure and index maps), the
row bucket, the number of inducing points (0 for a dense plan), the dtype, ``iters``, ``gtol``,
``memory_size``, the number of restarts (the batch of the step's L-BFGS),
the device, the jitter settings the captured work bakes in, and the mesh
(the step's own and ``config.mesh_descriptor()``), so a step captured
without a mesh is never replayed under one.  A
:class:`~gpar_torch.models.fused.MeshScanStep` whose shards all lie on one
card is captured like the one-device step: its per-shard work is more
launches on the same stream.  A mesh over distinct cards runs eagerly
(``fused.make_scan_fit_body``).

- The bodies read everything from the step's static buffers; the layer's
  plan slice is copied on the device from the stacked plan by a layer
  index that also lives on the device, so one graph per body serves all
  layers.
- Before the captures, every body runs once on a clone of the step, on a
  side stream, as ``torch.cuda.graph`` requires (it creates the cuBLAS and
  cuSOLVER handles and the autograd state); the clone keeps that warm-up
  from moving the fit's state.
- A replay computes what the eager step computes, each body with the
  jitter rule the step gives it (``fused.ScanStep``; the rules and their
  replay, read and repair are ``ops.linalg``'s module docstring's).
  ``iters`` is in the key, so the rule of a step's evaluations is too.
- Launch counters: a capture runs the kernel wrappers' Python once and a
  replay runs none, so :class:`GraphedStep` records what each capture
  added to the counters of ``ops.gram_kernel``, takes it back out, and
  adds it again on every replay.  The counts are launches that ran.
- The cache is a least-recently-used map bounded by bytes: each entry
  records what it pins on the card (its step's buffers and its graphs'
  memory pools), read as the rise of reserved memory across the step's
  construction and capture with the allocator's unused cache released on
  both sides; after a capture the least recently used entries are evicted
  (:func:`evictions`) until the sum fits ``config.graph_cache_max_bytes``
  (None: half of the card's memory) and at most :data:`CACHE_CAP` keys
  remain.  An evicted entry's graphs are reset and the allocator's unused
  cache released, so its pools go back to the card.  On an H100 the dense
  step of the benchmark's model at 11 840 rows pins 13.8 GiB in float32
  (two fit half the card, a third evicts), the sparse step with 256
  inducing points 0.39 GiB.  A step over the budget on its own serves its
  fit and is not kept; the others stay.
- A cached step is shared mutable state: it serves one fit at a time.
  Two fits of the same key that run at once (two threads) would overwrite
  each other's buffers.
- There is no fallback: a capture or replay that fails raises.

The estimator's cached ``replace=True`` predict on the card with no mesh
(the factors from its factor slot; ``predict``, ``sample(posterior=True)``
and ``warmup()``) replays a tail graph instead of the eager tail
(:func:`graphed_tail`): a :class:`~gpar_torch.models.fused.CachedTailBody`
captured once per key, in the same cache, under the same byte budget, cap
and eviction, its Gram counters re-added on every replay, its capture the
span ``gpar.predict.capture``.

- Its key is tagged ``"tail"`` and covers the plan's fingerprint, the
  training row bucket, the number of inducing points (0 dense), p, the
  number of samples, the test bucket, ``latent``, the dtype, the device,
  the jitter settings and ``config.mesh_descriptor()``.
- A call copies, on the device, the latents, the stacked factors, the
  bucketed training row arrays, the test inputs, weights, mask and
  normals into the body's buffers, and replays the eager tail's chain with
  each sampling factor at its first rung, writing the draws, the means and
  each layer's ``cholesky_ex`` flag, (p,), into the graph's own outputs,
  which the call copies.
- Then one host read of the (p,) flags, in place of one a layer (span
  ``gpar.predict.replay``, with the replay; ``fused.run_tail``), and the
  repair of each layer whose first rung failed, eagerly (one span
  ``gpar.predict.repair``); later layers feed forward the mean, not the
  draws, and need nothing.  The answer is the eager tail's in every case.
- A cached tail is shared mutable state too: it serves one predict at a
  time.

The estimator's uncached ``replace=True`` predict on the card with no mesh
(a dense stack over ``config.posterior_cache_max_bytes``, or
``config.posterior_cache`` off: the route that conditions every layer
inside the predict) replays an uncached tail graph instead of
``fused.make_scan_predict_tail``'s eager loop
(:func:`graphed_uncached_tail`): a
:class:`~gpar_torch.models.fused.UncachedTailBody` in the same cache,
under the same budget, cap and eviction, its capture the same span.

- Its key is tagged ``"uncached_tail"`` and covers the plan's
  fingerprint, the training row bucket, the number of inducing points (0
  dense), p, the number of samples, the test bucket, ``latent``, the
  dtype, the device, the jitter settings and ``config.mesh_descriptor()``.
- A call copies the latents, the bucketed training inputs and row arrays,
  the inducing inputs, the test inputs, weights, mask and normals into the
  body's buffers; the replay runs the eager tail's chain with every
  layer's training factors (``ops.linalg.Jitter("first_rung")``) and
  sampling factor at the first rung, and writes the draws, the means and
  the failures: each sampling factor's flag and the rule's count.
- Then one host read of the failures (span ``gpar.predict.replay``, with
  the replay and the outputs' copies) in place of two a layer.  Where any
  is not 0 the whole eager tail runs again on the host ladders (span
  ``gpar.predict.repair``; ``fused.run_tail`` as above): a failed training
  factor poisons every later layer, and keeping each layer's factors for a
  repair by layer would pin the stack the factor cache refused.  The
  answer is the eager tail's in every case.
"""

import collections
import gc
import time

import torch

from ..config import config, mesh_descriptor
from ..ops import gram_kernel as GK
from ..ops.linalg import jitter_key
from ..utils.spans import span
from .fused import (
    CachedTailBody, UncachedTailBody, new_step, plan_static_fingerprint, run_tail,
)

__all__ = ["GraphedStep", "graphed_step", "graphed_tail", "graphed_uncached_tail", "on_card",
           "clear_cache", "evictions", "cached_bytes", "CACHE_CAP"]

_CACHE = collections.OrderedDict()  # key -> (step, graphs, pinned bytes), least recent first
#: Most keys the cache holds, the cap of the JAX package's program cache; the
#: byte budget (``config.graph_cache_max_bytes``) is the other bound.
CACHE_CAP = 64


def evictions(sizes, max_bytes, cap):
    """The keys to evict from a cache whose entries pin ``sizes``, a list of
    ``(key, bytes)`` from the least to the most recently used: first every
    entry over ``max_bytes`` on its own, then the least recently used,
    until the rest sum to at most ``max_bytes`` and number at most
    ``cap``."""
    out = [key for key, b in sizes if b > max_bytes]
    rest = [(key, b) for key, b in sizes if b <= max_bytes]
    total, n = sum(b for _, b in rest), len(rest)
    for key, b in rest:
        if total <= max_bytes and n <= cap:
            break
        out.append(key)
        total, n = total - b, n - 1
    return out


def cached_bytes():
    """What the cached steps and tails pin, summed (bytes)."""
    return sum(entry[2] for entry in _CACHE.values())


def on_card(device):
    """Whether ``device`` is a CUDA device, where graphs are captured."""
    return torch.device(device).type == "cuda"


def _reserved(device):
    """Reserved device memory once the allocator's unused cache is
    released: the live tensors and the captured graphs' pools (0 off the
    card, where nothing is captured)."""
    if not on_card(device):
        return 0
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


def _budget(device):
    """``config.graph_cache_max_bytes``, or half of the card's memory."""
    if config.graph_cache_max_bytes is not None:
        return config.graph_cache_max_bytes
    if not on_card(device):
        return float("inf")
    return torch.cuda.get_device_properties(device).total_memory // 2


class GraphedStep:
    """Every body of ``step`` captured once; ``self(name)`` replays body
    ``name`` and returns what the body returned at the capture, the graph's
    outputs.  ``capture_s`` is the wall-clock of warm-up and captures, the
    step's span ``CAPTURE_SPAN``; ``replays`` counts replays."""

    def __init__(self, step):
        device = step.device
        t0 = time.perf_counter()
        with span(step.CAPTURE_SPAN), torch.cuda.device(device):
            warm = step.clone()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for name in step.BODIES:
                    getattr(warm, name)()
            torch.cuda.current_stream(device).wait_stream(side)
            del warm
            self.graphs, self.counts, self.outputs = {}, {}, {}
            for name in step.BODIES:
                before = GK.counters()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self.outputs[name] = getattr(step, name)()
                after = GK.counters()
                GK.set_counters(before)
                self.graphs[name] = graph
                self.counts[name] = {k: after[k] - before[k] for k in after}
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def __call__(self, name):
        self.graphs[name].replay()
        GK.add_counters(self.counts[name])
        self.replays += 1
        return self.outputs[name]


def _key(plan, n_rows, n_ind, dtype, device, iters, gtol, memory_size, restarts=1, mesh=None):
    return (
        plan_static_fingerprint(plan), n_rows, n_ind, str(dtype), str(device), iters, gtol,
        memory_size, restarts, *jitter_key(), mesh, mesh_descriptor(), config.dense_shard_block,
    )


def graphed_step(plan, n_rows, n_ind, dtype, device, iters, gtol, memory_size, args, restarts=1,
                 mesh=None):
    """``(step, graphs, capture_s)`` for a fit: the cached step of this key
    with ``args`` (``ScanStep.load``'s) loaded, or a new one, loaded and
    captured (``capture_s`` is 0 on a hit); a new step enters the cache and
    the byte budget evicts as the module says."""
    key = _key(plan, n_rows, n_ind, dtype, device, iters, gtol, memory_size, restarts, mesh)
    return _cached(key, device, args, lambda: new_step(plan, n_rows, n_ind, dtype, device, gtol,
                                                       memory_size, restarts, mesh, iters))


def graphed_tail(plan, latent, z_all, factors, x_test, w_test_T, normals, xs_rows, mt):
    """``(batch, mean_chain)`` of ``fused.make_scan_cached_tail(plan,
    latent, rows_traced=True)`` for these arguments, from the cached tail
    graph of their key (captured on a miss, as the module says): the
    replay, one host read, and the repair of any layer whose first rung
    failed."""
    n_ind = factors["zi_aug"].shape[1] if plan.sparse else 0
    args = (z_all, factors, x_test, w_test_T, normals, xs_rows, mt)
    return _replayed_tail("tail", plan, latent, xs_rows["obs_mask"].shape[-1], n_ind, args,
                          CachedTailBody)


def graphed_uncached_tail(plan, x_ind, latent, z_all, x, x_test, w_test_T, normals, xs_rows, mt):
    """``(batch, mean_chain)`` of ``fused.make_scan_predict_tail(plan,
    x_ind, latent, rows_traced=True)`` for these arguments, from the
    uncached tail graph of their key (captured on a miss, as the module
    says): the replay, one host read, and the whole eager tail again where
    any first rung failed."""
    n_ind = 0 if x_ind is None else x_ind.shape[0]
    args = (z_all, x, x_ind, x_test, w_test_T, normals, xs_rows, mt)
    return _replayed_tail("uncached_tail", plan, latent, x.shape[0], n_ind, args,
                          UncachedTailBody)


def _replayed_tail(tag, plan, latent, n_rows, n_ind, args, body):
    """``fused.run_tail`` of the tail graph keyed by ``tag`` and the rest
    of the module's tail key, ``args`` loaded into a ``body(plan, latent,
    *args)`` (the last five: the test inputs, weights, normals, row arrays
    and mask)."""
    x_test, normals = args[-5], args[-3]
    key = (tag, plan_static_fingerprint(plan), n_rows, n_ind, plan.p, normals.shape[1],
           x_test.shape[0], latent, str(x_test.dtype), str(x_test.device), *jitter_key(),
           mesh_descriptor())
    step, graphs, _ = _cached(key, x_test.device, args, lambda: body(plan, latent, *args))
    return run_tail(step, graphs)


def _cached(key, device, args, new):
    """``(step, graphs, capture_s)``: the entry of ``key`` with ``args``
    loaded, or ``new()`` loaded and captured; a new entry enters the cache
    with what it pins, and the byte budget evicts."""
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        step, graphs, _ = hit
        step.load(*args)
        return step, graphs, 0.0
    before = _reserved(device)
    step = new()
    step.load(*args)
    graphs = GraphedStep(step)
    _CACHE[key] = (step, graphs, max(_reserved(device) - before, 0))
    gone = evictions([(k, e[2]) for k, e in _CACHE.items()], _budget(device), CACHE_CAP)
    for k in gone:
        # The new entry serves this call even when it is not kept.
        _evict(k, reset=k != key and on_card(device))
    if gone:
        _reserved(device)
    return step, graphs, graphs.capture_s


def _evict(key, reset):
    """Drop ``key``'s entry; with ``reset`` also its graphs, whose pools the
    allocator then returns to the card."""
    graphs = _CACHE.pop(key)[1]
    if reset:
        for graph in graphs.graphs.values():
            graph.reset()


def clear_cache():
    """Drop every captured step and tail (and their buffers and graph memory)."""
    _CACHE.clear()
