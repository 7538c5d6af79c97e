"""gpar_torch.utils.data and gpar_torch.utils.experiment against the JAX
package's modules of the same names.

- Every loader, on its synthetic branch, on the CSV fixtures in
  ``tests/fixtures/`` and on a directory without the file (the warning and
  the synthetic fallback), and ``chain_functions`` return arrays equal to
  the JAX package's bit for bit, NaNs in the same places.
- ``kv``, ``Counter`` and ``check_metric`` print the same text, and
  ``check_metric`` raises the same ``SystemExit``; a ``WorkingDirectory``
  pickle written by either package is the same file and loads in the other.
- ``fit(fused=False)`` prints the reference's ``Training conditionals``
  progress line, as the JAX package's per-layer driver does; the unrolled
  fit prints nothing.
"""

import os
import warnings

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, chain_data, torch  # noqa: F401

import gpar_tpu.models.regressor as JR  # noqa: E402
import gpar_tpu.utils.data as JD  # noqa: E402
import gpar_tpu.utils.experiment as JE  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402

import gpar_torch.utils.data as TD  # noqa: E402
import gpar_torch.utils.experiment as TE  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

LOADERS = {
    "eeg": lambda mod, d: mod.load_eeg(d),
    "exchange": lambda mod, d: mod.load_exchange(d),
    "jura": lambda mod, d: mod.load_jura(d),
    "air_temp0": lambda mod, d: mod.load_air_temp(d, size=0),
    "air_temp2": lambda mod, d: mod.load_air_temp(d, size=2),
}


def _same(a, b):
    """Nested loader outputs equal bit for bit (NaNs in the same places)."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def _load(mod, name, source, tmp_path):
    """The loader's output and the warnings it raised."""
    data_dir = {"synthetic": None, "fixtures": FIXTURES, "missing": str(tmp_path)}[source]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = LOADERS[name](mod, data_dir)
    return out, [(w.category, str(w.message)) for w in rec]


@pytest.mark.parametrize("source", ["synthetic", "fixtures", "missing"])
@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_matches_jax(name, source, tmp_path):
    got, got_warn = _load(TD, name, source, tmp_path)
    want, want_warn = _load(JD, name, source, tmp_path)
    _same(got, want)
    assert got_warn == want_warn
    # A fixture file exists only for size 0 of the air temperature.
    falls_back = source == "missing" or (source == "fixtures" and name == "air_temp2")
    assert any("falling back" in m for _, m in got_warn) == falls_back


@pytest.mark.parametrize("p,seed,noise", [(1, 0, 0.05), (4, 3, 0.1)])
def test_chain_functions_match_jax(p, seed, noise):
    x = np.linspace(0, 1, 37)
    _same(TD.chain_functions(x, p, seed=seed, noise=noise),
          JD.chain_functions(x, p, seed=seed, noise=noise))


def _printed(capsys, mod, fn):
    fn(mod)
    return capsys.readouterr().out


def _report(mod):
    mod.kv("metric", 1.23456789)
    mod.kv("array", np.array([1.0, 2.5, np.nan]))
    mod.kv("list", [0.1, 0.2])
    mod.kv("name", "eeg")
    with mod.Counter(name="Training conditionals", total=3) as c:
        for _ in range(3):
            c.count()
    with mod.Counter(name="untotalled") as c:
        c.count()
    with mod.Counter(name="quiet", total=2, verbose=False) as c:
        c.count()
    mod.check_metric("eeg mean SMSE", 0.2, 0.30)
    mod.check_metric("score", 2.0, 1.0, larger_is_worse=False)


def test_experiment_output_matches_jax(capsys):
    got = _printed(capsys, TE, _report)
    want = _printed(capsys, JE, _report)
    assert got == want
    assert "\rTraining conditionals: 3/3\n" in got and "quiet" not in got


@pytest.mark.parametrize("args", [("jura Cd MAE", 0.31, 0.3), ("score", 0.5, 1.0, False)])
def test_check_metric_failure_matches_jax(capsys, args):
    msgs = []
    for mod in (TE, JE):
        with pytest.raises(SystemExit) as e:
            mod.check_metric(*args)
        msgs.append((e.value.code, capsys.readouterr().out))
    assert msgs[0] == msgs[1]
    assert msgs[0][0].startswith("Quality gate failed")


def test_working_directory_pickles_cross(tmp_path):
    obj = {"x": np.linspace(0, 1, 5), "means": np.array([[1.0, np.nan]]), "name": "eeg"}
    wt = TE.WorkingDirectory(str(tmp_path), "torch", seed=4)
    draw_t = np.random.rand()
    wj = JE.WorkingDirectory(str(tmp_path), "jax", seed=4)
    assert np.random.rand() == draw_t  # both seed NumPy's global generator
    wt.save(obj, "sub", "out.pickle")
    wj.save(obj, "sub", "out.pickle")
    with open(wt.file("sub", "out.pickle"), "rb") as a, open(wj.file("sub", "out.pickle"), "rb") as b:
        assert a.read() == b.read()
    for loaded in (wj.load("..", "torch", "sub", "out.pickle"),
                   wt.load("..", "jax", "sub", "out.pickle")):
        assert loaded.keys() == obj.keys() and loaded["name"] == "eeg"
        _same([loaded["x"], loaded["means"]], [obj["x"], obj["means"]])


def test_per_layer_driver_prints_the_progress_line(capsys, monkeypatch):
    # Fails without the Counter: the port's per-layer driver printed nothing.
    # JAX's per-layer optimiser is stubbed: its compiles take seconds and
    # print nothing; the progress line is the driver's own.
    x, y, _ = chain_data(n=16, p=2, seed=1)
    kw = dict(bench_kwargs(n_ind=4), x_ind=None)
    monkeypatch.setattr(JR, "minimise_l_bfgs_b", lambda *args, **kwargs: 0.0)
    JReg(**kw).fit(x, y, iters=1, fused=False, fix=False)
    want = capsys.readouterr().out
    rt = TReg(**kw, device="cpu")
    rt.fit(x, y, iters=1, fused=False)
    assert capsys.readouterr().out == want
    assert want == ("Training conditionals: 0/2\rTraining conditionals: 1/2"
                    "\rTraining conditionals: 2/2\n")
    rt.fit(x, y, iters=1, fused="unroll")  # JAX's unrolled fit reports nothing either
    rt.fit(x, y, iters=1)
    assert capsys.readouterr().out == ""
