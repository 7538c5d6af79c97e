"""Named spans of the port's phases on ``torch.profiler``'s timeline.

``span(name)`` marks a phase of ``fit`` or ``predict`` on the host while a
``torch.profiler`` records: ``fit(profile_dir=)``, or a profiler the caller
runs around any entry point.  The span is a profiler range
(``_RecordFunctionFast``, the range torch's compiled code marks its kernels
with): it lands among the host's events in the same kineto event stream as
the device's activity, on the same clock, and TensorBoard shows it with no
exporter of its own.  Unlike ``torch.profiler.record_function`` it leaves no
mirror on the device's timeline and costs about a seventh of its time (an
empty span 1.6 against 11.8 µs, torch 2.11 on an H100 machine's host), so
the scan fit's launch spans do not slow a profiled fit.  Spans of one call
nest by time on the calling thread.  With no profiler recording, a span is
one flag check and the shared null context; nothing is recorded.

The spans and what each covers (sites in ``models/regressor.py``,
``models/fused.py``, ``models/graphs.py`` and ``params/``):

- ``gpar.condition``: host transforms, normalisation and the upload of the
  inputs;
- ``gpar.fit``: the whole of ``fit``, greedy search, conditioning and the
  report included;
- ``gpar.fit.prepare``: the scan fit's host set-up up to its first body run:
  the plan, the bucketed inputs, the latents, the graph-cache lookup and the
  step's load;
- ``gpar.fit.capture``: the warm-up and capture of the step's CUDA graphs,
  on a graph-cache miss only (``capture_s``);
- ``gpar.fit.launch``: one body run of the scan fit's loop (``layer_init``,
  ``step``, ``trial``, ``commit``, ``layer_finish``): a graph replay, or the
  eager body;
- ``gpar.fit.read``: one host read of an optimiser's flags or of a fit's
  results, on every route of ``fit``, each counted in ``host_syncs``: the
  host blocked on the device;
- ``gpar.fit.repair``: one layer of the scan fit run again, eagerly, on the
  full jitter ladder after a read found a first-rung failure
  (``ladder_repairs``); its bodies have no launch span, its reads their
  read spans;
- ``gpar.predict``: the whole of ``predict``; its own time, outside the
  spans below, is the preparation of the inputs (padding, normals, uploads,
  the plan);
- ``gpar.predict.tail``: the route's tail: the posterior factors where they
  are not cached, and the draws;
- inside it, on the per-sample (``replace=False``) route:
  ``gpar.predict.layer_factors``, one layer's training factors as the tail
  takes them (computed anew, with the imputation of the layer before,
  where they are not cached); ``gpar.predict.chunk``, one layer and chunk
  of samples (the Grams, the posterior, the covariance and the draws); and
  inside each chunk ``gpar.predict.sample_factor``, the batched sampling
  factor with its host reads of ``info``;
- ``gpar.predict.summary``: the undone transforms, the mean and the
  quantiles;
- ``gpar.predict.read``: the copies of the summary to the host, which wait
  for the queued device work.

No span lies inside a body captured as a CUDA graph: it would be recorded
at the capture and never at a replay.
"""

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["span"]

_NULL = contextlib.nullcontext()


def span(name):
    """A profiler range called ``name`` while a profiler records, else the
    shared null context."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _NULL
