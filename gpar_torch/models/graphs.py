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
"""

import collections
import gc
import time

import torch

from ..config import config
from ..ops import gram_kernel as GK
from .fused import ScanStep, plan_static_fingerprint

__all__ = ["GraphedStep", "graphed_step", "clear_cache", "evictions", "cached_bytes", "CACHE_CAP"]

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
    """What the cached steps pin, summed (bytes)."""
    return sum(entry[2] for entry in _CACHE.values())


def _on_card(device):
    return torch.device(device).type == "cuda"


def _reserved(device):
    """Reserved device memory once the allocator's unused cache is
    released: the live tensors and the captured graphs' pools (0 off the
    card, where nothing is captured)."""
    if not _on_card(device):
        return 0
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


def _budget(device):
    """``config.graph_cache_max_bytes``, or half of the card's memory."""
    if config.graph_cache_max_bytes is not None:
        return config.graph_cache_max_bytes
    if not _on_card(device):
        return float("inf")
    return torch.cuda.get_device_properties(device).total_memory // 2


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
    captured (``capture_s`` is 0 on a hit); a new step enters the cache and
    the byte budget evicts as the module says."""
    key = _key(plan, n_rows, n_ind, dtype, device, iters, gtol, memory_size, restarts)
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        step, graphs, _ = hit
        step.load(*args)
        return step, graphs, 0.0
    before = _reserved(device)
    step = ScanStep(plan, n_rows, n_ind, dtype, device, gtol, memory_size, restarts)
    step.load(*args)
    graphs = GraphedStep(step)
    _CACHE[key] = (step, graphs, max(_reserved(device) - before, 0))
    gone = evictions([(k, e[2]) for k, e in _CACHE.items()], _budget(device), CACHE_CAP)
    for k in gone:
        # The new step serves this fit even when it is not kept.
        _evict(k, reset=k != key and _on_card(device))
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
    """Drop every captured step (and its buffers and graph memory)."""
    _CACHE.clear()
