"""Global configuration for gpar-torch.

The counterpart of ``gpar_tpu/config.py``: one mutable ``config`` object
holding the Cholesky jitter policy (the ``lab.B.epsilon`` analogue and its
float32 floor), the escalating retry ladder, the default dtype and the
default device, the scan-fused serving switch ``scan_predict``, the
per-sample tails' memory knobs and the posterior-factor cache
(``gpar_tpu/config.py:190-234``), the byte budget of the CUDA-graph cache;
and the row buckets of the scan-fused path
(:func:`bucket_rows`, the JAX package's default ``bucket_ratio`` and
``bucket_floor``, ``gpar_tpu/config.py:162-173,324-334``).  On the card
a bucket is the unit a captured CUDA graph serves: every dataset whose
row count falls in one bucket replays the same graphs.  The JAX
package's ``shape_buckets`` switch and sample buckets are not carried
over: the port's scan routes always bucket rows, and its predict tails
run eagerly at the caller's sample count.  The XLA-only knobs (compile cache, Pallas
toggle, blocked Cholesky) have no counterpart here either.

The device mesh (``gpar_tpu/config.py:174-189,244-310``): ``mesh``,
``shard_axis``, ``shard_min_rows`` and ``dense_shard_block``, set for a
block of calls by :func:`use_mesh`, and :func:`mesh_descriptor`, the
mesh's part of every cache key.  A mesh is a
:class:`gpar_torch.parallel.Mesh`, a tuple of devices driven from this one
process (``gpar_torch/parallel/``).

Precision: every float32 Gram, solve and matmul runs in full IEEE float32.
PyTorch's CUDA matmuls and cuDNN convolutions may otherwise use TF32
(about three decimal digits) — unusable where the Cholesky jitter is 1e-6
— so TF32 is switched off here at import, the analogue of the JAX
package's ``jax_default_matmul_precision="highest"``.

float64 is the default dtype (the parity bar of the reference suite);
set ``GPAR_TORCH_NO_X64=1`` before import, or assign ``config.dtype``, for
float32.
"""

import contextlib
import os

import torch

__all__ = ["config", "default_dtype", "resolve_device", "bucket_rows", "use_mesh",
           "mesh_descriptor"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: Geometric ratio between consecutive row buckets.
BUCKET_RATIO = 1.25
#: Smallest row bucket, and the multiple every bucket rounds up to.
BUCKET_FLOOR = 64


class _Config:
    """Mutable global configuration (mirrors ``lab.B.epsilon``)."""

    def __init__(self):
        #: Diagonal jitter added before every Cholesky factorisation.
        self.epsilon = 1e-12
        #: Jitter floor for float32 matrices, where 1e-12 is below working
        #: resolution; the effective float32 jitter is
        #: ``max(epsilon, epsilon_f32)``.
        self.epsilon_f32 = 1e-6
        #: Multiplicative factors of ``epsilon`` for the escalating retries
        #: after a failed factorisation.
        self.cholesky_retry_factors = (1e3, 1e6)
        #: Default dtype of parameters and data.
        self.dtype = (
            torch.float32 if os.environ.get("GPAR_TORCH_NO_X64") else torch.float64
        )
        #: Default device of the entry points.  ``"cuda"`` raises when no
        #: card is present; pass ``device="cpu"`` to run on the host.
        self.device = "cuda"
        #: Scan-fused serving (``models/fused.py``): posterior ``predict`` /
        #: ``fit_predict`` / ``sample`` in both ``replace`` modes, prior
        #: ``sample`` and ``logpdf`` run the scan tails and chains on rows
        #: padded to their bucket.  False forces the unrolled oracle
        #: everywhere: the conditioned GPAR (``GPAR | data``) and
        #: ``GPAR.sample_batch`` at the exact test rows, ``logpdf`` through
        #: the GP core, and no posterior-factor cache.  Mirrors
        #: ``gpar_tpu/config.py:190-205``.
        self.scan_predict = True
        #: Sample-axis chunk of the per-sample tails (``replace=False``
        #: prediction, ``sample``): ``"auto"`` sizes it so that about four
        #: (chunk, n_test, n_test) buffers fit ``predict_memory_budget``;
        #: an integer fixes it; ``None`` or 0 takes every sample at once.
        #: Chunked draws equal unchunked ones.  This and the budget mirror
        #: the reference package's public settings of the same names and
        #: defaults (``gpar_tpu/config.py:218-234``).
        self.predict_sample_chunk = "auto"
        #: Bytes the ``"auto"`` sample chunk sizes its buffers for.
        self.predict_memory_budget = 2 << 30
        #: Keep each estimator's per-layer posterior factors across
        #: ``predict`` / ``sample`` / posterior ``logpdf`` calls (one slot,
        #: keyed on the latents, the row bucket, the width, dtype and
        #: device); False conditions anew on every call, the reference's
        #: behaviour (``gpar/regression.py:547``).  This and the byte limit
        #: mirror ``gpar_tpu/config.py:214-217``.
        self.posterior_cache = True
        #: Largest dense factor stack, p * rows * (rows + W + 1) elements at
        #: the row bucket, that is cached; a sparse stack (p M^2) always is.
        self.posterior_cache_max_bytes = 1 << 30
        #: Byte budget of the CUDA-graph cache of the scan step
        #: (``models/graphs.py``): least recently used steps are evicted
        #: until what the cached steps pin fits it; None is half of the
        #: card's memory.
        self.graph_cache_max_bytes = None
        #: The device mesh of the sharded routes (a
        #: :class:`gpar_torch.parallel.Mesh`), or None: set it through
        #: :func:`use_mesh` or the entry points' ``mesh=``.  Under a mesh the
        #: scan fits and scores shard their data rows over its devices (the
        #: Titsias statistics summed across shards, the dense covariance
        #: factored by the distributed blocked Cholesky), and sampling splits
        #: its sample axis.
        self.mesh = None
        #: Name of the mesh axis rows and samples are split over.
        self.shard_axis = "dp"
        #: Fits and scores with fewer rows than this (or than the mesh has
        #: devices) stay on one device.
        self.shard_min_rows = 1024
        #: Panel width of the distributed dense Cholesky
        #: (``parallel/dense.py``), shrunk for small problems.
        self.dense_shard_block = 256


config = _Config()


def _distributed_world_size():
    """The ``torch.distributed`` world size, 1 when it is not initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def check_single_process():
    """Raise when this process is one rank of several: a mesh is driven
    from one process, which must reach every device's shards (the JAX
    package's ``process_count() > 1`` guard, ``gpar_tpu/config.py:266-271``)."""
    if _distributed_world_size() > 1:
        raise NotImplementedError(
            "gpar_torch meshes are single-process: host-side placement of "
            "plan/data arrays assumes all mesh devices are addressable from "
            "this process."
        )


@contextlib.contextmanager
def use_mesh(mesh, min_rows=None, axis=None):
    """Run the enclosed fits, scores and predictions sharded over ``mesh``
    (``gpar_tpu/config.py:244-279``): the rows of the scan fits and scores
    split over its devices, the sample axis of sampling too.  ``min_rows``
    and ``axis`` set ``shard_min_rows`` and ``shard_axis`` for the block;
    all three are restored on exit.  Raises ``NotImplementedError`` in one
    rank of a multi-process ``torch.distributed`` group.

    Example::

        mesh = gpar_torch.parallel.make_mesh(4, devices=[torch.device("cuda")] * 4)
        with gpar_torch.use_mesh(mesh):
            reg.fit(x, y)
            means = reg.predict(x_new)
    """
    check_single_process()
    prev = (config.mesh, config.shard_min_rows, config.shard_axis)
    config.mesh = mesh
    if min_rows is not None:
        config.shard_min_rows = min_rows
    if axis is not None:
        config.shard_axis = axis
    try:
        yield mesh
    finally:
        config.mesh, config.shard_min_rows, config.shard_axis = prev


def mesh_context(mesh):
    """``use_mesh(mesh)``, or no change for None: the entry points'
    ``mesh=``, which an enclosing :func:`use_mesh` serves as well."""
    return contextlib.nullcontext() if mesh is None else use_mesh(mesh)


def mesh_descriptor():
    """The active mesh's part of a cache key (``gpar_tpu/config.py:
    282-310``): its axis, size and devices, ``shard_axis``,
    ``shard_min_rows`` and the dense panel width; None without a mesh.  A
    graphed step or a factor stack made under one mesh is never reused
    under another, or without one."""
    m = config.mesh
    if m is None:
        return None
    return (tuple(m.axis_names), m.size, tuple(str(d) for d in m.devices), config.shard_axis,
            config.shard_min_rows, config.dense_shard_block)


def default_dtype():
    return config.dtype


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` or ``config.device``.

    Never falls back to the CPU silently: asking for CUDA on a machine
    without a usable card raises."""
    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"gpar_torch: device {str(dev)!r} requested but CUDA is not "
            "available; pass device='cpu' to run on the host."
        )
    return dev


def bucket_rows(n):
    """Smallest row bucket >= ``n``: geometric steps of
    :data:`BUCKET_RATIO` from :data:`BUCKET_FLOOR`, each rounded up to a
    :data:`BUCKET_FLOOR` multiple.  The scan-fused fit pads its data rows,
    and the predict tail its test rows, to this bucket; padded rows are
    masked out exactly."""
    if n <= 0:
        return n
    q = b = BUCKET_FLOOR
    while b < n:
        b = int(-(-int(b * BUCKET_RATIO) // q) * q)
    return b
