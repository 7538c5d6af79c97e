"""CUDA graphs of the scan-fused layer step.

The port's counterpart of ``jax.jit`` of the scan body and of the JAX
package's cross-instance program cache (``regressor._shared_jit``,
``gpar_tpu/models/regressor.py:1404-1432``): each body of a
:class:`~gpar_torch.models.fused.ScanStep` is captured once with
``torch.cuda.graph`` per key and replayed for every layer, every L-BFGS
iteration and every later fit with the same key, by any estimator.  The
key covers the plan's fingerprint (model structure and index maps), the
row bucket, the number of inducing points (0 for a dense plan), the dtype, ``iters``, ``gtol``,
``memory_size``, the number of restarts (the batch of the step's L-BFGS),
the device and the jitter settings the captured work bakes in.

- The bodies read everything from the step's static buffers; the layer's
  plan slice is copied on the device from the stacked plan by a layer
  index that also lives on the device, so one graph per body serves all
  layers.
- Before the captures, every body runs once on a clone of the step, on a
  side stream, as ``torch.cuda.graph`` requires (it creates the cuBLAS and
  cuSOLVER handles and the autograd state); the clone keeps that warm-up
  from moving the fit's state.
- The Cholesky jitter ladder runs on the device inside the bodies
  (``ops.linalg.cholesky_ladder_on_device``): a replay computes what the eager step
  computes, so a replayed state never needs redoing.
- Launch counters: a capture runs the kernel wrappers' Python once and a
  replay runs none, so :class:`GraphedStep` records what each capture
  added to the counters of ``ops.gram_kernel``, takes it back out, and
  adds it again on every replay.  The counts are launches that ran.
- The cache is a least-recently-used map of at most :data:`CACHE_CAP`
  keys, the cap of the JAX package's ``_SHARED_JIT_CACHE``; each entry
  pins its step's buffers and its graphs' memory pools on the card until
  it is evicted or :func:`clear_cache` runs.  A dense step's pools hold
  its (rows, rows) temporaries: on an H100, 13.8 GiB for the benchmark's
  model at 11 840 rows in float32, against 0.39 GiB for the sparse step
  with 256 inducing points.
- A cached step is shared mutable state: it serves one fit at a time.
  Two fits of the same key that run at once (two threads) would overwrite
  each other's buffers.
- There is no fallback: a capture or replay that fails raises.
"""

import collections
import time

import torch

from ..config import config
from ..ops import gram_kernel as GK
from .fused import ScanStep, plan_static_fingerprint

__all__ = ["GraphedStep", "graphed_step", "clear_cache", "CACHE_CAP"]

_CACHE = collections.OrderedDict()
#: Most keys the cache holds; the least recently used goes first.
CACHE_CAP = 64


class GraphedStep:
    """Every body of ``step`` captured once; ``self(name)`` replays body
    ``name``.  ``capture_s`` is the wall-clock of warm-up and captures,
    ``replays`` counts replays and ``replayed`` what they added to each
    counter of ``ops.gram_kernel``."""

    def __init__(self, step):
        device = step.device
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            warm = step.clone()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for name in step.BODIES:
                    getattr(warm, name)()
            torch.cuda.current_stream(device).wait_stream(side)
            del warm
            self.graphs, self.counts = {}, {}
            for name in step.BODIES:
                before = GK.counters()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    getattr(step, name)()
                after = GK.counters()
                GK.set_counters(before)
                self.graphs[name] = graph
                self.counts[name] = {k: after[k] - before[k] for k in after}
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0
        self.replayed = dict.fromkeys(GK.counters(), 0)  # counter increments from replays

    def __call__(self, name):
        self.graphs[name].replay()
        GK.add_counters(self.counts[name])
        self.replays += 1
        for k, v in self.counts[name].items():
            self.replayed[k] += v


def _key(plan, n_rows, n_ind, dtype, device, iters, gtol, memory_size, restarts=1):
    return (
        plan_static_fingerprint(plan), n_rows, n_ind, str(dtype), str(device), iters, gtol,
        memory_size, restarts, config.epsilon, config.epsilon_f32,
        tuple(config.cholesky_retry_factors),
    )


def graphed_step(plan, n_rows, n_ind, dtype, device, iters, gtol, memory_size, args, restarts=1):
    """``(step, graphs, capture_s)`` for a fit: the cached step of this key
    with ``args`` (``ScanStep.load``'s) loaded, or a new one, loaded and
    captured (``capture_s`` is 0 on a hit)."""
    key = _key(plan, n_rows, n_ind, dtype, device, iters, gtol, memory_size, restarts)
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        step, graphs = hit
        step.load(*args)
        return step, graphs, 0.0
    step = ScanStep(plan, n_rows, n_ind, dtype, device, gtol, memory_size, restarts)
    step.load(*args)
    graphs = GraphedStep(step)
    _CACHE[key] = (step, graphs)
    if len(_CACHE) > CACHE_CAP:
        _CACHE.popitem(last=False)
    return step, graphs, graphs.capture_s


def clear_cache():
    """Drop every captured step (and its buffers and graph memory)."""
    _CACHE.clear()
