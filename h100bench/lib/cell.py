"""One run of one cell: set-up, the closed loop over the measured window,
the profiled requests of a ``--trace 1`` run, then the check against the
reference and the result line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, ``configs/<config>.json``, ``traffic/<traffic>.json``,
the entry that traffic names (``entries/<entry>.py``: its set-up, its
timed call, its end-to-end numbers, its work counts and its comparison
with the reference), ``limits/<cell>.json`` and, per metric,
``layer_metrics/<name>.py`` (or ``layer_metrics/<name up to the first
dot>.py``, which is given the rest as its variant).  An end-to-end metric
is the entry's number of the name up to the first dot.
"""

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import check, traffic as T
from .data import model_kwargs
from .profile import profiled, span

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "gpar_tpu")


def _json(path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Spec:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic, limits
    and the metrics it reports."""

    def __init__(self, name, bench=None, cfg=None, traffic=None, limits=None):
        """``cfg``, ``traffic`` and ``limits`` stand in for the files (a test
        at a small size)."""
        bench = _json(ROOT / "BENCHMARK.json") if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.name, self.cell = name, cells[name]
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.cfg = cfg or _json(ROOT / cfgs[self.cell["config"]]["file"])
        self.traffic = traffic or _json(BENCH / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = limits or _json(BENCH / "limits" / f"{name}.json")["limits"]

        def mine(ms):
            return [m for m in ms if name in m.get("workloads", [name])]

        self.end_to_end = mine(bench["end_to_end"])
        self.per_layer = mine(bench["per_layer"])
        self.entry = importlib.import_module(f"h100bench.entries.{self.traffic['entry']}")


def reader(metric_name):
    """The reader of a per-layer metric and its variant."""
    stem, _, variant = metric_name.partition(".")
    for stem, variant in ((metric_name, None), (stem, variant or None)):
        path = BENCH / "layer_metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"h100bench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read, (variant if stem != metric_name else None)
    raise SystemExit(f"no reader for per-layer metric {metric_name!r}")


class Context:
    """What a per-layer reader reads: the window's ``records`` (one dict per
    request: ``wall_s``, ``size``, ``counters``, and for a fit its
    ``report``), the profiled requests' ``trace`` and ``traced`` records,
    ``peak_bytes``, and ``work(record)``, the operations and the Gram
    bound (ms) that a request's mathematics needs."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Run:
    """What an entry works with: the configuration, the traffic, the seed,
    the device and dtype, ``log``, and :meth:`estimator`."""

    def __init__(self, cfg, traffic, seed, device, dtype, log):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.dtype, self.log = device, dtype, log

    def estimator(self, x):
        from gpar_torch import GPARRegressor

        return GPARRegressor(**model_kwargs(self.cfg["model"], x), device=self.device,
                             dtype=self.dtype)

    def sizes(self, n):
        """The sizes the work counts read, at ``n`` data rows."""
        cfg = self.cfg
        return {"n": n, "m": int(cfg["m"]), "M": int(cfg["model"]["inducing"]),
                "p": int(cfg["p"]), "itemsize": self.dtype.itemsize}


def run(spec, seed, seconds, trace, device="cuda", t_start=None, log=print, control=False):
    """One run; returns ``(result, checks)``: the result line's object and
    the compared numbers as ``(name, value, limit)``.  ``log`` receives
    the run's lines for standard error.  ``control`` (for setting the
    limits, never in a benchmark run): the same numbers also for the control,
    the reference in the precision below the configuration's, in the
    program's place, as ``result["control"]``."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import gpar_torch
    from gpar_torch.ops import gram_kernel as GK

    cfg, tr, E = spec.cfg, spec.traffic, spec.entry
    r = Run(cfg, tr, seed, device, getattr(torch, cfg["dtype"]), log)
    gpar_torch.config.epsilon = float(cfg["jitter"])

    def do(req, record=True):
        """One request; returns its record."""
        GK.reset_counters()
        rec = E.call(r, state, req, record)
        out = rec["outputs"] if cfg["credible_bounds"] else (rec["outputs"],)
        if not all(np.isfinite(a).all() for a in out):
            raise FloatingPointError("non-finite predictions")
        rec.update(req=req, size=req["size"], counters=GK.counters(),
                   outputs=out if record else None)
        return rec

    # -- set-up ---------------------------------------------------------------
    state = E.setup(r)
    for k in range(int(tr["warm_requests"])):
        do(T.warm_request(tr, cfg, seed, k), record=False)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    # -- the measured window ----------------------------------------------------
    records, failed, k = [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        req = T.request(tr, cfg, seed, k)
        k += 1
        try:
            records.append(do(req))
        except (RuntimeError, FloatingPointError, ValueError) as e:
            failed += 1
            log(f"[window] request {req['k']} failed: {type(e).__name__}: {e}")
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules that no run may load are loaded: {bad}")
    log(f"[window] {len(records)} requests completed, {failed} failed, in {window_s:.3f} s")

    # -- the profiled requests ----------------------------------------------------
    traced, tr_obj = [], None
    if trace:
        with profiled() as got:
            for j in range(int(tr["profiled_requests"])):
                req = T.request(tr, cfg, seed, k + j)
                with span():
                    traced.append(do(req, record=False))
        tr_obj = got[0]

    # -- the check -----------------------------------------------------------------
    state.pop("model", None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    items = sample(records, int(tr["checked_requests"]), seed)
    t_check = time.perf_counter()
    numbers = E.judge(r, state, items, log=log)
    low = E.judge(r, state, items, E.control(r, state), log=log) if control else None
    correct, rows = check.verdict(numbers, spec.limits)
    log(f"[check] {len(items)} requests against the reference in "
        f"{time.perf_counter() - t_check:.3f} s")
    correct = correct and failed == 0 and len(records) > 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules that no run may load are loaded: {bad}")

    # -- the result line ----------------------------------------------------------
    ctx = Context(records=records, traced=traced, trace=tr_obj, cfg=cfg, traffic=tr,
                  window_s=window_s, peak_bytes=peak, work=lambda rec: E.work(r, rec))
    metrics = {}
    if trace:
        for m in spec.per_layer:
            read, variant = reader(m["name"])
            v = read(ctx, variant)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(E.end_to_end(records, window_s), setup_s=setup_s)
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "count": 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(records) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=tr_obj.busy_s(), window_s=tr_obj.window_s())
        result["breakdown"] = {"device_ops": tr_obj.top_ops(), "idle_gaps": tr_obj.idle_gaps()}
    if low is not None:
        result["control"] = low
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows


def sample(records, count, seed):
    """The requests checked: ``count`` drawn from the seed, the largest
    among them."""
    if len(records) <= count:
        return list(records)
    big = max(range(len(records)), key=lambda i: records[i]["size"])
    rest = [i for i in range(len(records)) if i != big]
    pick = np.random.default_rng(T.derive_seed(seed, 7)).choice(rest, count - 1, replace=False)
    return [records[i] for i in sorted([big, *pick.tolist()])]
