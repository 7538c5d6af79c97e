"""A whole run of each cell, on the CPU at a small size (the look for a
card skipped), with the timed path broken underneath: ``correct`` comes out
false for every fault the cell's entry can have (its ``FAULTS``), and true
without one.  A fit cell can leave its state unchanged, leave half of its
rows out, follow a wrong gradient or alter an answer; every cell can leave
half of its draws out or alter an answer.  One card, so no exchange between
chips can be left out."""

import contextlib
import json
from pathlib import Path

import pytest

from h100bench.lib import cell, faults
from h100bench.tests.tiny import config

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]
CASES = [(c, f) for c in CELLS for f in (None, *cell.Spec(c).entry.FAULTS)]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_makes_the_run_incorrect(workload, fault):
    spec = cell.Spec(workload, cfg=config(workload.split(".")[0]))
    with faults.plant(fault) if fault else contextlib.nullcontext():
        result, rows = cell.run(spec, 2**31 + 977, 0.5, False, device="cpu", log=lambda s: None)
    assert result["correct"] is (fault is None), rows
    assert list(result)[-1] == "checks"
