"""The control on the card: the reference computed in float32 (float64 cells),
put in the program's place, must come out as not correct under each cell's
limits, while the program itself comes out correct.  At a size a test run
holds (p = 4, rows near 2000); the readings at the cells' own sizes are in
PERF.md.  Run on a machine with an H100:

    python -m pytest h100bench/tests/test_h100bench_control.py -m cuda
"""

import pytest

from h100bench.lib import cell, check
from h100bench.tests.tiny import config


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cells' sizes there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sparse-m256-p16-f64.fit_predict", "dense-p16-n4k-f64.fit_predict",
                                      "sparse-m256-p16-f64.serve", "dense-p16-n4k-f64.serve"])
def test_the_control_is_not_correct(card, workload):
    name = workload.split(".")[0]
    cfg = config(name, p=4, rows=[1900, 2400], serve_rows=2000, test_points=256, samples=50)
    if cfg["model"]["inducing"]:
        cfg["model"]["inducing"] = 64
    spec = cell.Spec(workload, cfg=cfg)
    result, rows = cell.run(spec, 4242, 3.0, False, device=card, log=print, control=True)
    assert result["correct"], rows
    low_ok, low_rows = check.verdict(result["control"], spec.limits)
    assert not low_ok, low_rows
