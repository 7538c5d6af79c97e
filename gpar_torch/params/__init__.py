from .optim import minimise_l_bfgs_b  # noqa: F401
from .store import Vars, VarsView, load_latents  # noqa: F401
