"""Random-number generators.

The JAX package keeps a global PRNG key split on every draw
(``gpar_tpu/utils/rng.py``).  The PyTorch counterpart is one
``torch.Generator`` per device, created on first use and reseeded by
:func:`set_seed`; every sampling entry point also takes an explicit
``generator=`` or caller-supplied standard normals.
"""

import secrets

import torch

__all__ = ["set_seed", "default_generator"]

_seed = None
_generators = {}


def set_seed(seed):
    """Seed (and reset) the default generator of every device."""
    global _seed
    _seed = int(seed)
    _generators.clear()


def default_generator(device):
    """The default ``torch.Generator`` of ``device`` (seeded from
    :func:`set_seed`, or randomly if it was never called)."""
    device = torch.device(device)
    key = str(device)
    gen = _generators.get(key)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(secrets.randbits(63) if _seed is None else _seed)
        _generators[key] = gen
    return gen
