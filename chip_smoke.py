#!/usr/bin/env python3
"""Smoke test of gpar_torch on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases (each raises on failure; the script exits 0 only if all pass):

1. Device and build: requires CUDA, prints the card's name and power
   limit, builds the hand-written kernels from the sources in the checkout.
2. Kernel check: the CUDA Gram kernel against its plain PyTorch version on
   the card, in float32 (rtol/atol 1e-5) and float64 (1e-12), on the
   benchmark's layer kernels at the main path's shapes — (256, 256),
   (256, 10000), (256, 1024), (1024, 1024), input widths 1 and 16 — plus a
   gated layer kernel and a ragged (37, 23) shape; the gradient of the
   fused Gram against autograd of the plain recursion; device times of
   kernel and plain version (``torch.profiler``) beside the card's bound.
3. Main path at full width: ``GPARRegressor.fit_predict`` at the
   benchmark's configuration (``bench.py``): n=10 000, p=16, 256 inducing
   points, 10 L-BFGS iterations per layer, 100-sample predictive with
   credible bounds at 1024 test inputs, float32, jitter 1e-6; held to the
   benchmark's ``10k`` quality gates; every Gram must have gone through the
   kernel.  Cold and warm wall-clocks.
4. Small-input agreement: a float64 fit_predict (p=3, n=100, 8 inducing
   points) on the card against the same run on the CPU (the CPU route is
   held against the JAX package by the test suite), rtol 1e-6.
5. Summary: a ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` additionally traces one warm fit_predict with
``torch.profiler`` and writes the per-kernel table to ``DIR``.
"""

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("GPAR_TORCH_NO_X64", "1")  # float32, as the benchmark

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
H100_FP64_FLOPS = 34e12  # float64 outside the tensor cores

# The benchmark's golden quality gates (bench.py QUALITY_GATES["10k"]).
GATES = dict(mean_smse=5e-4, worst_smse=2e-3, nll_decrease=5e4)


def make_data(n=10_000, p=16, seed=0):
    """The benchmark's synthetic closed-downwards chain (``bench.py``):
    returns ``(x, y, f)`` with ``f`` the noiseless truth."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, size=n))
    cols = [np.sin(x) - x**2 / 50.0]
    for i in range(1, p):
        prev = cols[-1]
        cols.append(np.cos(prev) ** 2 + np.sin((i + 1) * x / 3.0) / (1 + i / 8.0))
    f = np.stack(cols, axis=1)
    y = f + 0.05 * rng.standard_normal((n, p))
    return x.astype(np.float32), y.astype(np.float32), f.astype(np.float32)


def model_kwargs(x, n_ind=256):
    """The benchmark's model (``bench.py`` build_model): air-temp style
    D-GPAR-L-NL with inducing points over the data range."""
    return dict(
        scale=0.2,
        linear=True,
        linear_scale=10.0,
        nonlinear=True,
        nonlinear_scale=1.0,
        noise=0.1,
        impute=True,
        replace=True,
        normalise_y=True,
        x_ind=np.linspace(float(x.min()), float(x.max()), n_ind),
    )


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, reps):
    """Device time per call: the summed durations of the CUDA kernels that
    ``reps`` calls of ``fn`` ran, from ``torch.profiler`` — unlike CUDA
    events around back-to-back launches, it excludes the gaps in which the
    card waits for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total_us = sum(e.device_time for e in prof.events() if e.device_type == cuda)
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / reps / 1e3


def gram_bound_ms(kinds, dims, n, m, itemsize):
    """Least time of one Gram on an H100: the larger of the bytes it must
    move (features read once, Gram written once) over the memory rate and
    its operations over the non-tensor-core rate of the dtype.  The function
    needs 2 operations per feature and output for every kind of term (a
    product and a sum; the norm identity reduces a squared distance to one
    inner product), whatever form the kernel chose."""
    D = sum(dims)
    bytes_ = itemsize * (n * m + (n + m) * D + 2 * len(kinds) + 1)
    per_elem = 2 * D + 4 * len(kinds) + 1  # tail per term (w*, exp, +) and the constant
    flops = n * m * per_elem
    peak = H100_FP32_FLOPS if itemsize == 4 else H100_FP64_FLOPS
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def layer_tree(pi, dtype, device, seed=1):
    """Layer ``pi``'s kernel as the estimator builds it for the benchmark's
    model, at seeded hyperparameters near their initial values."""
    import torch

    from gpar_torch.models.regressor import _model_generator, GPARRegressor
    from gpar_torch.params.store import Vars, load_latents

    cfg = GPARRegressor(**model_kwargs(np.zeros(2)), device=device, dtype=dtype).model_config
    vs = Vars(dtype=dtype, device=device)
    gen = _model_generator(vs, 1, pi, **cfg)
    gen()
    r = np.random.default_rng(seed + pi)
    snap = vs.snapshot()
    load_latents(vs, {k: v + 0.2 * r.standard_normal(v.shape) for k, v in snap.items()})
    return gen()[0].kernel


def gated_tree(dtype, device, m=1, P1=15, pi=9):
    """A gated layer kernel built like the JAX scan body's
    ``_layer_kernel``: inputs gated to the first ``m`` columns, outputs to
    the ``pi`` modelled ones."""
    import torch

    from gpar_torch.ops.kernels import EQ, Linear

    def P(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    out_gate = (np.arange(P1) < pi).astype(float)
    r = np.random.default_rng(3)
    k = (P(1.3) * EQ().stretch(P(np.r_[[0.2] * m, np.ones(P1)]))).gate(P(np.r_[np.ones(m), np.zeros(P1)]))
    gate_out = P(np.r_[np.zeros(m), out_gate])
    k = k + Linear().stretch(P(np.r_[np.ones(m), r.uniform(5, 15, P1)])).gate(gate_out)
    k = k + P(0.8) * EQ().stretch(P(np.r_[np.ones(m), r.uniform(0.5, 2, P1)])).gate(gate_out)
    return k


def inputs(n, d, dtype, device, seed):
    import torch

    r = np.random.default_rng(seed)
    a = np.concatenate([r.uniform(0, 10, (n, 1)), r.standard_normal((n, d - 1))], axis=1)
    return torch.as_tensor(a, dtype=dtype, device=device)


def phase_kernel_check(device):
    import torch

    from gpar_torch.ops import gram_kernel as GK
    from gpar_torch.ops.kernels import gram_eval

    shapes = [(256, 256), (256, 10_000), (256, 1024), (1024, 1024)]
    rows = []
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    for dtype in (torch.float32, torch.float64):
        cases = [("bench-pi0", layer_tree(0, dtype, device), 1)]
        cases.append(("bench-pi15", layer_tree(15, dtype, device), 16))
        cases.append(("gated", gated_tree(dtype, device), 16))
        for name, tree, d in cases:
            for n, m in shapes + [(37, 23)]:
                if name == "gated" and (n, m) != (256, 10_000):
                    continue
                x = inputs(n, d, dtype, device, seed=n + d)
                y = inputs(m, d, dtype, device, seed=m + 7 * d)
                prep = GK.prepare_terms(tree, x, y)
                got = GK.gram_kernel_launch(*prep)
                torch.cuda.synchronize()
                want = GK.gram_terms_plain(*prep)
                torch.cuda.synchronize()
                err = float(torch.max(torch.abs(got - want)))
                scale = float(torch.max(torch.abs(want)))
                ok = bool(torch.allclose(got, want, rtol=tol[dtype], atol=tol[dtype]))
                print(f"[kernel] {name} {str(dtype)[6:]} ({n}, {m}) d={d}: "
                      f"max|err| {err:.3e} (max|K| {scale:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"gram kernel disagrees with its plain version: {name} {dtype} {(n, m)}")
                worst[dtype] = max(worst[dtype], err)
                if dtype == torch.float32 and name != "gated" and (n, m) != (37, 23):
                    kinds, dims = prep[0], prep[1]
                    k_ms = device_ms(lambda: GK.gram_kernel_launch(*prep), 50)
                    p_ms = device_ms(lambda: GK.gram_terms_plain(*prep), 50)
                    b_ms, b_by = gram_bound_ms(kinds, dims, n, m, 4)
                    rows.append(dict(tree=name, n=n, m=m, d=d, ms=k_ms, plain_ms=p_ms,
                                     bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
                    print(f"[kernel] time {name} ({n}, {m}) f32: kernel {k_ms:.5f} ms device, "
                          f"plain {p_ms:.5f} ms device, bound {b_ms:.6f} ms ({b_by})")

    # Gradient of the fused Gram (kernel forward, VJP of the plain
    # recursion) against autograd through the plain recursion.
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        tree = layer_tree(15, dtype, device)
        leaves = [l.detach().requires_grad_(True) for l in GK._leaves(tree)]
        tree, _ = GK._with_leaves(tree, leaves)
        x = inputs(256, 16, dtype, device, seed=11).requires_grad_(True)
        y = inputs(1024, 16, dtype, device, seed=12).requires_grad_(True)
        R = torch.randn(256, 1024, dtype=dtype, device=device, generator=torch.Generator(device).manual_seed(0))
        g1 = torch.autograd.grad(torch.sum(GK._GramFn.apply(tree, x, y, *leaves) * R), [x, y, *leaves])
        g2 = torch.autograd.grad(torch.sum(gram_eval(tree, x, y) * R), [x, y, *leaves])
        torch.cuda.synchronize()
        for a, b in zip(g1, g2):
            if not torch.allclose(a, b, rtol=rtol, atol=rtol * float(b.abs().max())):
                raise AssertionError(f"fused Gram gradient disagrees ({dtype})")
        print(f"[kernel] gradient {str(dtype)[6:]}: ok ({len(g1)} tensors)")
    return rows, worst


def phase_main_path(device):
    import torch

    import gpar_torch
    from gpar_torch import GPARRegressor
    from gpar_torch.ops import gram_kernel as GK
    from gpar_torch.utils.metrics import smse

    gpar_torch.config.epsilon = 1e-6  # float32 jitter floor, as bench.py
    n, p, n_test, num_samples, iters = 10_000, 16, 1024, 100, 10
    x, y, f = make_data(n, p)
    test_idx = np.arange(n)[:: n // n_test][:n_test]
    x_test, f_test = x[test_idx], f[test_idx]

    reg = GPARRegressor(**model_kwargs(x), device=device)
    assert reg.dtype == torch.float32
    reg.condition(x, y)
    reg._ensure_vars(reg.p)
    z_init = reg.vs.snapshot()

    def run(seed):
        reg.vs.restore(z_init)
        gen = torch.Generator(device).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reg.fit_predict(x, y, x_test, iters=iters, num_samples=num_samples,
                              credible_bounds=True, generator=gen)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    GK.reset_counters()
    (mean, lo, hi), cold = run(0)
    launches, plain_calls = GK.gram_kernel_launches, GK.gram_plain_cuda_calls
    rep = reg.last_fit_report
    (mean_w, _, _), warm = run(0)

    for a in (mean, lo, hi):
        assert a.shape == (n_test, p) and np.isfinite(a).all(), "non-finite or misshapen predictions"
    assert np.all(lo <= mean + 1e-6) and np.all(mean <= hi + 1e-6), "mean outside its credible bounds"
    nll0, nll = float(np.sum(rep["layer_nll0"])), float(np.sum(rep["layer_nll"]))
    s = smse(mean, f_test)
    mean_s, worst_s = float(np.nanmean(s)), float(np.nanmax(s))
    print(f"[main] fit_predict n={n} p={p} m=256 n_test={n_test} S={num_samples} iters={iters} f32: "
          f"cold {cold:.3f} s, warm {warm:.3f} s (fit {rep['wall_clock_s']:.3f} s of the cold run)")
    print(f"[main] sum NLL {nll0:.1f} -> {nll:.1f} (decrease {nll0 - nll:.1f}); "
          f"L-BFGS iterations per layer {rep['layer_iters'].tolist()}")
    print(f"[main] SMSE vs noiseless truth: mean {mean_s:.3e}, worst {worst_s:.3e}; "
          f"warm-run mean differs by {float(np.max(np.abs(mean_w - mean))):.3e}")
    print(f"[main] gram kernel launches {launches}, plain-route CUDA Grams {plain_calls}")
    if nll0 - nll < GATES["nll_decrease"]:
        raise AssertionError(f"NLL decrease {nll0 - nll:.1f} below {GATES['nll_decrease']}")
    if mean_s > GATES["mean_smse"] or worst_s > GATES["worst_smse"]:
        raise AssertionError(f"SMSE mean {mean_s:.3e} / worst {worst_s:.3e} above the gates")
    if launches <= 0 or plain_calls != 0:
        raise AssertionError(f"main path bypassed the kernel: {launches} launches, {plain_calls} plain")
    return dict(launches=launches, cold_s=cold, warm_s=warm, nll_decrease=nll0 - nll,
                mean_smse=mean_s, worst_smse=worst_s), (reg, x, y, x_test, z_init)


def phase_small_agreement():
    import torch

    from gpar_torch import GPARRegressor

    rng = np.random.default_rng(4)
    x, y, _ = make_data(100, 3, seed=4)
    x, y = x.astype(np.float64), y.astype(np.float64)
    xt = np.linspace(0.3, 9.7, 15)
    normals = rng.standard_normal((3, 8, 15))
    outs = {}
    for dev in ("cuda", "cpu"):
        reg = GPARRegressor(**model_kwargs(x, n_ind=8), device=dev, dtype=torch.float64)
        res = reg.fit_predict(x, y, xt, iters=5, num_samples=8, credible_bounds=True, normals=normals)
        outs[dev] = (res, reg.vs.snapshot(), reg.last_fit_report["layer_nll"])
    (rc, lc, nc), (rh, lh, nh) = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(nc, nh, rtol=1e-6)
    for k in lh:
        np.testing.assert_allclose(lc[k], lh[k], rtol=1e-6, atol=1e-8)
    for a, b in zip(rc, rh):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    print(f"[small] float64 fit_predict on cuda == cpu (rtol 1e-6): layer NLL {nc.tolist()}")


def phase_profile(state, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    reg, x, y, x_test, z_init = state
    reg.vs.restore(z_init)
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator("cuda").manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg.fit_predict(x, y, x_test, iters=10, num_samples=100, credible_bounds=True, generator=gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, "profile_table.txt"), "w") as fh:
        fh.write(table)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3
    gram = sum(e.device_time for e in events if "gram_tile_kernel" in e.name) / 1e3
    print(f"[profile] warm fit_predict under the profiler: wall {wall_ms:.1f} ms, device kernel "
          f"time {busy:.1f} ms over {len(events)} kernels (busy {100 * busy / wall_ms:.1f}%), "
          f"of which gram kernel {gram:.2f} ms; table in {out_dir}")
    print(table)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import gpar_torch  # noqa: F401 — fails outside a checkout of the repo
    from gpar_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card}; torch {torch.__version__} (CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    info = _build.build("gram")
    print(f"[build] {time.perf_counter() - t0:.2f} s: gram -> {info['path']} "
          f"(nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    rows, worst = phase_kernel_check("cuda")
    main_res, state = phase_main_path("cuda")
    phase_small_agreement()
    if "--profile" in argv:
        phase_profile(state, argv[argv.index("--profile") + 1])

    big = next(r for r in rows if r["tree"] == "bench-pi15" and (r["n"], r["m"]) == (256, 10_000))
    kernels = {"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "gpar_torch/csrc/gram.cu",
        "replaces": "gpar_tpu/ops/pallas_gram.py:167",
        "launches": main_res["launches"],
        "check": "kernel == plain at f32 rtol/atol 1e-5 and f64 1e-12; fused-Gram gradient == autograd",
        "max_abs_err": worst[torch.float32],
        "ms": big["ms"],
        "kernel_ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "shape": [big["n"], big["m"], big["d"]],
        "dtype": "float32",
        "per_shape": rows,
    }]}
    print("[main] " + json.dumps(main_res))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
