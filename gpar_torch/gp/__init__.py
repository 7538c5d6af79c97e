from .core import (  # noqa: F401
    FDD,
    GP,
    PseudoObs,
    SparsePosteriorGP,
    TitsiasObs,
    condition,
)
