"""The one request generator: a traffic file's parameters and a
configuration's sizes become the run's request list, drawn from the seed.

A traffic file (``h100bench/traffic/<mix>.json``) names the ``entry`` its
requests call (``h100bench/entries/<entry>.py``) and its parameters:
``size_range``, the range of a request's size ([lo, hi], or the name of the
configuration's key that holds it), ``sizes``, the number of sizes on an
even grid over that range; ``warm_requests``, ``profiled_requests``,
``checked_requests``; ``test_range`` for fresh test inputs; ``kwargs``
passed to the program's call where the entry takes them.

Every seed gets the same set of sizes, in its own order, and its own data:
the amount of work is fixed and only the values and the order move with
the seed.  A request's inputs are made from its own seeds when it is due,
and again when the reference needs them.
"""

import numpy as np

from .data import make_data


def _grid(lo, hi, k):
    return [int(lo + round((hi - lo) * (j + 0.5) / k)) for j in range(k)]


def derive_seed(*parts):
    """A seed of 63 bits derived from the run's seed and a request's own
    parts, so that every request's inputs can be made again."""
    return int(np.random.SeedSequence([int(q) for q in parts]).generate_state(1, np.uint64)[0] >> 1)


def _sizes(traffic, cfg):
    lo, hi = cfg[traffic["size_range"]] if isinstance(traffic["size_range"], str) \
        else traffic["size_range"]
    return _grid(int(lo), int(hi), int(traffic["sizes"]))


def request(traffic, cfg, seed, k):
    """Request ``k`` of the run with ``seed``: its size (rows of a fresh
    dataset, or test inputs) and the seeds of its data and normals."""
    sizes = _sizes(traffic, cfg)
    cycle, j = divmod(k, len(sizes))
    order = np.random.default_rng(derive_seed(seed, 1, cycle)).permutation(len(sizes))
    return {"k": k, "size": sizes[order[j]], "data_seed": derive_seed(seed, 2, k),
            "normals_seed": derive_seed(seed, 3, k)}


def fit_inputs(cfg, req):
    """``(x, y, x_test)`` of a ``fit_predict`` request: a fresh dataset of
    ``size`` rows and every ``size // test_points``-th row as a test input."""
    n, T = req["size"], int(cfg["test_points"])
    x, y, _ = make_data(n, int(cfg["p"]), req["data_seed"])
    return x, y, x[:: n // T][:T]


def serve_data(cfg, traffic, seed):
    """The dataset a serving cell fits once in set-up."""
    return make_data(int(cfg["serve_rows"]), int(cfg["p"]), derive_seed(seed, 4))


def test_inputs(traffic, req):
    """A ``predict`` request's fresh test inputs, uniform over the traffic's
    ``test_range``."""
    lo, hi = traffic["test_range"]
    rng = np.random.default_rng(req["data_seed"])
    return rng.uniform(lo, hi, size=req["size"]).astype(np.float32)


def normals(cfg, req, t, device, dtype):
    """The standard normals of a request's draws, (p, samples, t), made on
    the device from the request's own seed."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(req["normals_seed"])
    return torch.randn((int(cfg["p"]), int(cfg["samples"]), t), generator=gen, device=device,
                       dtype=dtype)


def warm_request(traffic, cfg, seed, k):
    """A warm-up request: the largest size of the grid, seeds apart from the
    timed requests'."""
    req = request(traffic, cfg, seed, 0)
    return dict(req, k=-1 - k, size=max(_sizes(traffic, cfg)), data_seed=derive_seed(seed, 5, k),
                normals_seed=derive_seed(seed, 6, k))
