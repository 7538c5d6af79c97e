"""The plain reference (``h100bench/reference/gpar.py``) against
``gpar_torch`` at a tiny size in float64 on the CPU: the fitted layers'
NLLs at their start and end, and the predictive from the same normals."""

import numpy as np
import pytest
import torch

from h100bench.lib import check, traffic as T
from h100bench.lib.data import model_kwargs
from h100bench.tests.tiny import config


@pytest.mark.parametrize("name", ["sparse-m256-p16-f64", "dense-p16-n4k-f64"])
def test_reference_agrees_with_the_port_in_float64(name, monkeypatch):
    import gpar_torch
    from gpar_torch import GPARRegressor

    cfg = config(name, jitter=1e-12)
    monkeypatch.setattr(gpar_torch.config, "epsilon", cfg["jitter"])
    req = {"size": 170, "data_seed": 11, "normals_seed": 12}
    x, y, x_test = T.fit_inputs(cfg, req)
    nrm = T.normals(cfg, req, len(x_test), "cpu", torch.float64)
    reg = GPARRegressor(**model_kwargs(cfg["model"], x), device="cpu", dtype=torch.float64)
    got = reg.fit_predict(x, y, x_test, iters=cfg["iters"], num_samples=cfg["samples"],
                          credible_bounds=True, normals=nrm)
    rep = reg.last_fit_report
    hypers = {k: np.asarray(v, float).reshape(-1).tolist() for k, v in reg.get_variables().items()}

    ref = check.Judge(cfg, "cpu")
    c = ref.condition(x, y, hypers, start=True)
    want = ref.predict(c, x_test, nrm)
    np.testing.assert_allclose(rep["layer_nll"], c["nll"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rep["layer_nll0"], c["nll0"], rtol=1e-9, atol=1e-9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
    # Every layer's fit gained, and shrank its gradient.
    assert all(a < b for a, b in zip(c["nll"], c["nll0"]))
    g = ref.condition(x, y, hypers, start=True, grads=True)
    assert all(a < b for a, b in zip(g["grad"], g["grad0"]))


def test_the_gradient_norm_matches_finite_differences():
    from h100bench.reference import gpar as R

    torch.manual_seed(0)
    x = torch.linspace(0, 10, 40, dtype=torch.float64)[:, None]
    x_aug = torch.cat([x, torch.sin(x)], 1)
    z_aug = x_aug[::5].clone()
    y = torch.cos(x[:, 0]) + 0.1 * torch.randn(40, dtype=torch.float64)
    values = {"1/input/var": [1.3], "1/input/scales": [0.7], "1/output/lin/scales": [2.0],
              "1/output/nonlin/var": [0.8], "1/output/nonlin/scales": [1.1], "1/noise": [0.05]}
    for z in (None, z_aug):
        def nll(lat):
            h = {name: lower + torch.exp(torch.tensor([v], dtype=torch.float64))
                 for (name, lower), v in zip(R.layer_names(1), lat)}
            return float(R.layer_nll(h, 1, 1, x_aug, z, y, 1e-9)[0])

        lat = [float(np.log(values[name][0] - lower)) for name, lower in R.layer_names(1)]
        eps, fd = 1e-6, []
        for j in range(len(lat)):
            up, dn = list(lat), list(lat)
            up[j] += eps
            dn[j] -= eps
            fd.append((nll(up) - nll(dn)) / (2 * eps))
        got = R.layer_grad_norm(values, 1, 1, x_aug, z, y, 1e-9)
        assert got == pytest.approx(float(np.linalg.norm(fd)), rel=1e-6)
