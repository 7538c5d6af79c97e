"""``BENCHMARK.json`` against the benchmark's contract, the traffic
generator's determinism, and the result line's shape."""

import json
import re
from pathlib import Path

import numpy as np

from h100bench.lib import cell, traffic as T

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "h100bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "h100bench" / "limits" / f"{w['name']}.json").exists()
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        # Each end-to-end metric is the entry's number of its stem.
        fake = [{"wall_s": 0.5}, {"wall_s": 1.5}]
        given = set(cell.Spec(w["name"]).entry.end_to_end(fake, 2.0)) | {"setup_s"}
        assert {m["name"].split(".")[0] for m in mine} <= given
        for m in BENCH["per_layer"]:
            if w["name"] in m["workloads"]:
                assert m["moves"] in {e["name"] for e in mine}
                cell.reader(m["name"])  # a reader exists
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("h100bench/")


def test_every_seed_gets_the_same_sizes_in_its_own_order():
    spec = cell.Spec("dense-p16-n4k-f64.fit_predict")
    k = int(spec.traffic["sizes"])
    a = [T.request(spec.traffic, spec.cfg, 5, i) for i in range(k)]
    b = [T.request(spec.traffic, spec.cfg, 2**31 + 5, i) for i in range(k)]
    assert sorted(r["size"] for r in a) == sorted(r["size"] for r in b)
    assert [r["size"] for r in a] != [r["size"] for r in b]
    lo, hi = spec.cfg["rows"]
    assert all(lo <= r["size"] <= hi for r in a)
    again = [T.request(spec.traffic, spec.cfg, 5, i) for i in range(k)]
    assert a == again
    x1 = T.fit_inputs(spec.cfg, a[0])
    x2 = T.fit_inputs(spec.cfg, again[0])
    assert all(np.array_equal(u, v) for u, v in zip(x1, x2))
    assert len(x1[2]) == spec.cfg["test_points"]


def test_serve_sizes_stay_in_one_test_bucket():
    from gpar_torch.config import bucket_rows

    spec = cell.Spec("sparse-m256-p16-f64.serve")
    sizes = {T.request(spec.traffic, spec.cfg, 9, i)["size"] for i in range(300)}
    assert sizes <= set(range(961, 1217))
    assert len({bucket_rows(t) for t in sizes}) == 1
    fit = cell.Spec("sparse-m256-p16-f64.fit_predict")
    lo, hi = fit.cfg["rows"]
    assert bucket_rows(lo) == bucket_rows(hi)
