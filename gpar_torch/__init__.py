"""gpar-torch: GPAR (Gaussian Process Autoregressive Regression,
arXiv:1802.07182) in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper.

A port of the JAX package ``gpar_tpu`` (the reference, kept beside it and
unchanged), with the same layout and public names.  It imports neither JAX
nor ``gpar_tpu``.  Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``.  ``use_mesh`` (or ``mesh=`` on the entry points)
shards the work over a device mesh of this process
(``gpar_torch.parallel``).
"""

from .config import config, use_mesh  # noqa: F401 — sets full-precision float32 matmuls
from .models.gpar import GPAR  # noqa: F401
from .models.regressor import (  # noqa: F401
    GPARRegressor,
    log_transform,
    squishing_transform,
)
from .utils.rng import set_seed  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "GPAR",
    "GPARRegressor",
    "log_transform",
    "squishing_transform",
    "set_seed",
    "config",
    "use_mesh",
]
