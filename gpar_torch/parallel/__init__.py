"""Execution over a device mesh: row-sharded sparse statistics
(``sharded``), the row-sharded exact dense path (``dense``), and the mesh
and its collectives (``mesh``).  The counterpart of ``gpar_tpu/parallel``:
a single-process mesh, whose shards may all lie on one card (a virtual
mesh) or on several.
"""

from .dense import sharded_dense_factors, sharded_dense_logpdf
from .mesh import Mesh
from .sharded import (
    make_mesh,
    pad_rows,
    sharded_sample_batch,
    sharded_titsias_elbo,
    sharded_titsias_factors,
    titsias_psum_body,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "pad_rows",
    "sharded_dense_factors",
    "sharded_dense_logpdf",
    "sharded_sample_batch",
    "sharded_titsias_elbo",
    "sharded_titsias_factors",
    "titsias_psum_body",
]
