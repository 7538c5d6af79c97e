"""Faults planted in the program underneath a run, for the tests and the
readings that set the limits (``h100bench/readings.py``): each is a context
manager that patches ``gpar_torch`` and undoes the patch.  A run never
plants one.  Plant a fault before the program captures its CUDA graphs (a
fresh process): a graph captured earlier replays the sound code.

- ``stale``: every L-BFGS step leaves the state where it was;
- ``half_rows``: each layer's objective leaves out every other data row and
  takes the mean over the rest, scaled to all rows;
- ``wrong_grad``: the Gram backward returns its gradient with the sign
  flipped, so the optimiser follows a wrong gradient of the kernel's
  hyperparameters;
- ``half_samples``: the predictive leaves out half of its draws and takes
  its mean and bounds over the rest;
- ``altered``: one predicted value is moved where it is produced, by one
  standard deviation of its output.
"""

import contextlib
import inspect

NAMES = ("stale", "half_rows", "wrong_grad", "half_samples", "altered")


@contextlib.contextmanager
def _patched(owner, attr, make):
    raw = inspect.getattr_static(owner, attr)
    setattr(owner, attr, make(getattr(owner, attr)))
    try:
        yield
    finally:
        setattr(owner, attr, raw)


def plant(name):
    """The context manager that plants fault ``name``."""
    from gpar_torch.models import fused
    from gpar_torch.models.regressor import GPARRegressor
    from gpar_torch.ops.gram_kernel import _GramFn
    from gpar_torch.params.lbfgs import DeviceLBFGS

    if name == "stale":
        return _patched(DeviceLBFGS, "commit", lambda old: lambda self: None)
    if name == "half_rows":
        def make(old):
            def nll_factors(plan, lin, z_full, x_aug, zi_aug, escalations=None):
                mask = lin["obs_mask"]
                keep = mask.clone()
                keep[1::2] = 0.0
                nll, factors = old(plan, dict(lin, obs_mask=keep), z_full, x_aug, zi_aug,
                                   escalations)
                return nll * (mask.sum() / keep.sum()), factors
            return nll_factors
        return _patched(fused, "_layer_nll_factors", make)
    if name == "wrong_grad":
        def make(old):
            def backward(ctx, g):
                return tuple(None if d is None else -d for d in old(ctx, g))
            return staticmethod(backward)
        return _patched(_GramFn, "backward", make)
    if name == "half_samples":
        def make(old):
            def sample_batch(self, *a, **kw):
                batch = old(self, *a, **kw)
                return batch[: batch.shape[0] // 2]
            return sample_batch
        return _patched(GPARRegressor, "_sample_batch", make)
    if name == "altered":
        def make(old):
            def sample_batch(self, *a, **kw):
                batch = old(self, *a, **kw).clone()
                batch[:, 0, 0] += 1.0  # model space: one standard deviation
                return batch
            return sample_batch
        return _patched(GPARRegressor, "_sample_batch", make)
    raise ValueError(f"unknown fault {name!r}; known: {NAMES}")
