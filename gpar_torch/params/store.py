"""Named variable store with constrained transforms — port of
``gpar_tpu/params/store.py`` (the ``varz.Vars`` replacement, reference call
sites ``gpar/regression.py:101-173,314,328-337``).

Variables live as unconstrained latents (tensors on the store's device);
constrained values come out of per-variable transforms:

- ``get(name, init)``: unconstrained (identity);
- ``bnd(name, init, lower=0, upper=None)``: lower-bounded through a
  shifted exp, or doubly bounded through a scaled logistic.

Variables are created on first access and cached by name, which keeps the
lazy ``model()`` closures idempotent.  A :class:`VarsView` substitutes
latents (e.g. slices of an optimiser's vector that requires grad) for a
subset of names.

Initial latents are computed in NumPy, exactly as the JAX package does,
and uploaded once, so both packages start from bit-identical latents.
"""

import fnmatch

import numpy as np
import torch

from ..config import default_dtype, resolve_device

__all__ = ["Vars", "VarsView", "load_latents"]


class _Identity:
    def constrain(self, latent):
        return latent

    def unconstrain(self, value):
        return value


class _LowerBounded:
    """value = lower + exp(latent) (``gpar/regression.py:169-173``)."""

    def __init__(self, lower):
        self.lower = lower

    def constrain(self, latent):
        return self.lower + torch.exp(latent)

    def unconstrain(self, value):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.log(np.asarray(value) - self.lower)


class _Bounded:
    """value = lower + (upper - lower) * sigmoid(latent)
    (``gpar/regression.py:107``)."""

    def __init__(self, lower, upper):
        self.lower = lower
        self.upper = upper

    def constrain(self, latent):
        return self.lower + (self.upper - self.lower) / (1.0 + torch.exp(-latent))

    def unconstrain(self, value):
        frac = (np.asarray(value) - self.lower) / (self.upper - self.lower)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.log(frac) - np.log1p(-frac)


class Vars:
    """Flat name -> (latent, transform) store (``varz.Vars(dtype)``).

    ``device`` defaults to ``config.device`` and, like every entry point,
    raises rather than fall back to the CPU when CUDA is absent."""

    def __init__(self, dtype=None, device=None):
        self.dtype = default_dtype() if dtype is None else dtype
        self.device = resolve_device(device)
        self._latents = {}  # name -> tensor (unconstrained), insertion order
        self._transforms = {}

    def _np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64

    def _var(self, name, init, transform):
        if name is None:
            raise ValueError("Variables must be named.")
        if name not in self._latents:
            init = np.asarray(init, dtype=self._np_dtype())
            latent = np.asarray(transform.unconstrain(init), dtype=self._np_dtype())
            self._latents[name] = torch.as_tensor(latent, device=self.device)
            self._transforms[name] = transform
        return self._transforms[name].constrain(self._latents[name])

    def get(self, init=None, name=None):
        """Unconstrained variable (``gpar/regression.py:137``)."""
        return self._var(name, init, _Identity())

    def bnd(self, init=None, name=None, lower=0.0, upper=None):
        """Bounded variable; positive by default (``vs.bnd``)."""
        transform = _LowerBounded(lower) if upper is None else _Bounded(lower, upper)
        return self._var(name, init, transform)

    @property
    def names(self):
        return list(self._latents.keys())

    def __contains__(self, name):
        return name in self._latents

    def __getitem__(self, name):
        """Constrained value (``gpar/regression.py:336``)."""
        return self._transforms[name].constrain(self._latents[name])

    def snapshot(self):
        """Copy of the current latents, name -> NumPy array (the format of
        ``gpar_tpu``'s ``Vars.snapshot()``)."""
        return {k: v.detach().cpu().numpy().copy() for k, v in self._latents.items()}

    def restore(self, snap):
        """Restore latents from a :meth:`snapshot`."""
        load_latents(self, snap)

    def select(self, patterns=None):
        """Names matched by glob patterns, in creation order
        (``names=[f"{pi}/*"]``, ``gpar/regression.py:452-456``)."""
        if patterns is None:
            return self.names
        if isinstance(patterns, str):
            patterns = [patterns]
        return [
            name
            for name in self._latents
            if any(fnmatch.fnmatchcase(name, pat) for pat in patterns)
        ]

    def latent_vector(self, names):
        """The selected latents concatenated into one flat vector."""
        if not names:
            return torch.zeros((0,), dtype=self.dtype, device=self.device)
        return torch.cat([self._latents[name].reshape(-1) for name in names])

    def split_latent_vector(self, names, vector):
        """Inverse of :meth:`latent_vector`: flat vector -> name -> latent
        (views of ``vector``, so autograd flows back to it).  A batch of
        vectors (B, d) gives latents with a leading batch axis."""
        out, off = {}, 0
        lead = vector.shape[:-1]
        for name in names:
            shape = self._latents[name].shape
            size = self._latents[name].numel()
            out[name] = vector[..., off : off + size].reshape((*lead, *shape))
            off += size
        return out

    def set_latent_vector(self, names, vector):
        for name, v in self.split_latent_vector(names, vector.detach()).items():
            self._latents[name] = v.clone()

    def with_latent_vector(self, names, vector):
        return VarsView(self, self.split_latent_vector(names, vector))


class VarsView:
    """Read-through view of a :class:`Vars` with substituted latents, passed
    to objectives during optimisation (``objective(vs)``,
    ``gpar/regression.py:434``)."""

    def __init__(self, base, overrides):
        self._base = base
        self._overrides = overrides

    @property
    def dtype(self):
        return self._base.dtype

    @property
    def device(self):
        return self._base.device

    def _resolve(self, name):
        latent = self._overrides.get(name, self._base._latents[name])
        return self._base._transforms[name].constrain(latent)

    def get(self, init=None, name=None):
        if name not in self._base:
            self._base.get(init=init, name=name)
        return self._resolve(name)

    def bnd(self, init=None, name=None, lower=0.0, upper=None):
        if name not in self._base:
            self._base.bnd(init=init, name=name, lower=lower, upper=upper)
        return self._resolve(name)

    @property
    def names(self):
        return self._base.names

    def __contains__(self, name):
        return name in self._base

    def __getitem__(self, name):
        return self._resolve(name)


def load_latents(vs, latents):
    """Fill the store ``vs`` from a name -> latent dict, e.g. what
    ``gpar_tpu``'s ``Vars.snapshot()`` returns.  Raises on a name the store
    does not hold and on a shape mismatch; the values are cast to the
    store's dtype and device."""
    unknown = [k for k in latents if k not in vs._transforms]
    if unknown:
        raise KeyError(f"load_latents(): unknown variable names {unknown}")
    for k, v in latents.items():
        arr = np.asarray(v)
        shape = tuple(vs._latents[k].shape)
        if arr.shape != shape:
            raise ValueError(
                f"load_latents(): {k!r} has shape {arr.shape}, the store holds {shape}"
            )
    for k, v in latents.items():
        vs._latents[k] = torch.as_tensor(
            np.array(v, dtype=vs._np_dtype()), device=vs.device
        )
