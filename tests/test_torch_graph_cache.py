"""The byte budget of gpar_torch's CUDA-graph cache (``models/graphs.py``),
on the CPU.

The eviction policy, :func:`graphs.evictions`, is a function of the
entries' sizes, driven here with stated sizes: the least recently used
entries go first, an entry over the budget on its own goes before them,
and what stays sums to at most the budget and counts at most the cap.
Then :func:`graphs.graphed_step` itself, with the capture stubbed out (it
needs the card) and the pinned bytes stated through the reserved-memory
reader; the card-side measurement is checked in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import gpar_torch.models.graphs as TGr
from gpar_torch import GPARRegressor as TReg
from gpar_torch.config import config as tconfig
from gpar_torch.models.fused import build_scan_fit_plan

from .torch_cases import bench_kwargs, chain_data

GIB = 1 << 30


@pytest.mark.parametrize("sizes,budget,cap,gone", [
    ([("a", 10), ("b", 20), ("c", 30)], 60, 64, []),
    ([("a", 10), ("b", 20), ("c", 30)], 59, 64, ["a"]),
    ([("a", 10), ("b", 20), ("c", 30)], 45, 64, ["a", "b"]),
    ([("a", 10), ("b", 20), ("c", 30)], 30, 64, ["a", "b"]),
    ([("a", 10), ("b", 20), ("c", 30)], 29, 64, ["c", "a"]),
    ([("a", 10), ("b", 100), ("c", 20)], 50, 64, ["b"]),
    ([("a", 1), ("b", 1), ("c", 1)], 100, 2, ["a"]),
    ([], 0, 64, []),
    # Dense bench-size steps (13.8 GiB each) under half an 80 GB card.
    ([(k, int(13.8 * GIB)) for k in "abc"], 40 * GIB, 64, ["a"]),
])
def test_evictions_keep_the_most_recent_within_the_budget(sizes, budget, cap, gone):
    assert TGr.evictions(sizes, budget, cap) == gone
    kept = [(k, b) for k, b in sizes if k not in gone]
    assert sum(b for _, b in kept) <= budget and len(kept) <= cap
    # Least recently used first: every kept entry that fits is more recent
    # than every evicted one that fits.
    order = [k for k, _ in sizes]
    fitting = [k for k in gone if dict(sizes)[k] <= budget]
    assert all(order.index(k) < order.index(j) for k in fitting for j, _ in kept)


@pytest.fixture
def fit(monkeypatch):
    """``fit(iters, nbytes)``: ``graphed_step`` on the CPU for a key that
    differs in ``iters``, the capture stubbed out and a new entry's pinned
    bytes stated as ``nbytes``."""
    x, y, _ = chain_data(n=30, p=2, seed=0)
    rt = TReg(**bench_kwargs(n_ind=4), device="cpu")
    rt.condition(x, y)
    rt._ensure_vars(rt.p)
    names = rt.vs.select(None)
    plan = build_scan_fit_plan(rt, names)
    x_pad, rows = rt._bucket_fit_inputs(plan)
    args = (rt.vs.latent_vector(names), x_pad, rows, rt.x_ind)
    reserved, pending = [0], [0]

    class Captured:
        capture_s = 1.0

        def __init__(self, step):
            reserved[0] += pending[0]

    monkeypatch.setattr(TGr, "GraphedStep", Captured)
    monkeypatch.setattr(TGr, "_reserved", lambda device: reserved[0])
    monkeypatch.setattr(TGr, "_CACHE", type(TGr._CACHE)())
    monkeypatch.setattr(tconfig, "graph_cache_max_bytes", 100)

    def run(iters, nbytes):
        pending[0] = nbytes
        return TGr.graphed_step(plan, x_pad.shape[0], 4, torch.float64, "cpu", iters, 1e-9, 10,
                                args)

    return run


def _keys():
    return [k[5] for k in TGr._CACHE]  # the key's iters


def test_graphed_step_evicts_by_bytes(fit):
    first = fit(1, 40)
    assert first[2] == 1.0 and TGr.cached_bytes() == 40
    fit(2, 50)
    assert _keys() == [1, 2] and TGr.cached_bytes() == 90
    hit = fit(1, 0)  # a hit: key 1 is now the most recent
    assert hit[2] == 0.0 and hit[0] is first[0]
    fit(3, 30)  # 120 > 100: key 2, the least recently used, goes
    assert _keys() == [1, 3] and TGr.cached_bytes() == 70
    over = fit(4, 120)  # over the budget on its own: serves its fit, is not kept
    assert over[2] == 1.0 and _keys() == [1, 3] and TGr.cached_bytes() == 70
    fit(5, 60)  # 130: key 1 goes
    assert _keys() == [3, 5] and TGr.cached_bytes() == 90
    fit(6, 80)  # 170: keys 3 and 5 go, in that order
    assert _keys() == [6] and TGr.cached_bytes() == 80 <= tconfig.graph_cache_max_bytes
    TGr.clear_cache()
    assert TGr.cached_bytes() == 0


def test_budget_defaults_to_half_the_card_and_is_unbounded_off_it(monkeypatch):
    monkeypatch.setattr(tconfig, "graph_cache_max_bytes", None)
    assert TGr._budget("cpu") == float("inf")
    monkeypatch.setattr(tconfig, "graph_cache_max_bytes", 123)
    assert TGr._budget("cpu") == 123
    assert TGr._reserved("cpu") == 0
    np.testing.assert_equal(TGr.CACHE_CAP, 64)
