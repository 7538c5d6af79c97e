"""Card-only tests of gpar_torch: the hand-written CUDA kernels against
their plain PyTorch versions, and the CUDA graphs of the scan-fused layer
step against the same step run eagerly.

This file imports neither JAX nor ``gpar_tpu``, so it runs on a machine
with PyTorch for CUDA alone; the suite's ``conftest.py`` configures JAX, so
skip it there::

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Every test skips without a CUDA device (a CUDA kernel has no CPU mode).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpar_torch import GPARRegressor  # noqa: E402
from gpar_torch.models.fused import Eager, ScanStep, build_scan_fit_plan  # noqa: E402
from gpar_torch.ops import gram_kernel as GK  # noqa: E402

from .torch_cases import CASES, FUSED, TorchFW, _inputs, bench_kwargs, chain_data  # noqa: E402


def _need_cuda():
    # Decided in the test, not at import: every worker must collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _tree(case, npdt, device):
    build, d = CASES[case]
    tree, _ = GK.map_leaves(build(TorchFW(npdt)), lambda l: l.to(device))
    return tree, d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain(dtype, tol):
    _need_cuda()
    npdt = np.float32 if dtype == torch.float32 else np.float64
    dev = torch.device("cuda")
    for case in FUSED:
        tree, d = _tree(case, npdt, dev)
        x, y = _inputs(d, npdt, n=300, m=133)
        prep = GK.prepare_terms(tree, torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        got = GK.gram_kernel_launch(*prep)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, GK.gram_terms_plain(*prep), rtol=tol, atol=tol, msg=case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_cuda_batched_kernel_matches_plain(dtype, tol):
    # A sample axis on either operand or both: one launch, S Grams.
    _need_cuda()
    npdt = np.float32 if dtype == torch.float32 else np.float64
    dev = torch.device("cuda")
    r = np.random.default_rng(6)
    for case in FUSED:
        tree, d = _tree(case, npdt, dev)
        xb, yb = (torch.as_tensor(r.normal(size=(5, k, d)).astype(npdt), device=dev) for k in (70, 133))
        for x, y in ((xb[0], yb), (xb, yb[0]), (xb, yb)):
            with torch.no_grad():
                prep = GK.prepare_terms(tree, x, y)
            launches = GK.gram_batched_kernel_launches
            got = GK.gram_kernel_launch(*prep)
            torch.cuda.synchronize()
            assert tuple(got.shape) == (5, 70, 133) and GK.gram_batched_kernel_launches == launches + 1
            torch.testing.assert_close(got, GK.gram_terms_plain(*prep), rtol=tol, atol=tol, msg=case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_cuda_backward_kernel_matches_plain(dtype, tol):
    _need_cuda()
    # Tolerance relative to the largest entry of each plain gradient: the
    # kernel sums over 133 or 300 terms in another order than the plain
    # version.
    npdt = np.float32 if dtype == torch.float32 else np.float64
    dev = torch.device("cuda")
    for case in FUSED:
        tree, d = _tree(case, npdt, dev)
        x, y = _inputs(d, npdt, n=300, m=133)
        prep = GK.prepare_terms(tree, torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        g = torch.as_tensor(np.random.default_rng(9).normal(size=(300, 133)).astype(npdt), device=dev)
        got = GK.gram_bwd_kernel_launch(*prep, g)
        torch.cuda.synchronize()
        for a, b in zip(got, GK.gram_terms_plain_vjp(*prep, g)):
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= tol * scale, case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_cuda_backward_kernel_at_the_lane_maps_edges_gives_the_same_bits(dtype, tol):
    _need_cuda()
    # Terms of 2, 15, 17, 33 and 64 features at ragged shapes on both row
    # tiles (index into _BWD_ROWS, by dtype; on 132 SMs); a second launch
    # gives the same bits (fixed-order sums, no atomics).
    npdt = np.float32 if dtype == torch.float32 else np.float64
    dev = torch.device("cuda")
    tree, d = _tree("edges", npdt, dev)
    small = 1 if dtype == torch.float32 else 0
    for n, m, tile in ((37, 23, 1), (300, 133, small), (1100, 700, 0)):
        x, y = _inputs(d, npdt, n=n, m=m)
        prep = GK.prepare_terms(tree, torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        assert GK._bwd_plan(n, m, len(prep[0]), dtype, dev)[3] == GK._BWD_ROWS[dtype][tile]
        g = torch.as_tensor(np.random.default_rng(n).normal(size=(n, m)).astype(npdt), device=dev)
        got = GK.gram_bwd_kernel_launch(*prep, g)
        again = GK.gram_bwd_kernel_launch(*prep, g)
        torch.cuda.synchronize()
        for a, b, c in zip(got, again, GK.gram_terms_plain_vjp(*prep, g)):
            assert torch.equal(a, b), (n, m)
            assert float((a - c).abs().max()) <= tol * max(float(c.abs().max()), 1e-30), (n, m)


def _small_step(dtype, dense=False, restarts=1):
    x, y, _ = chain_data(n=100, p=3, seed=0)
    y[::7, 2] = np.nan
    kw = dict(bench_kwargs(n_ind=8), **({"x_ind": None} if dense else {}))
    reg = GPARRegressor(**kw, device="cuda", dtype=dtype)
    reg.condition(x, y)
    reg._ensure_vars(reg.p)
    names = reg.vs.select(None)
    plan = build_scan_fit_plan(reg, names)
    x_pad, rows = reg._bucket_fit_inputs(plan)
    zi = x_pad.new_zeros((0, plan.m)) if dense else reg.x_ind
    step = ScanStep(plan, x_pad.shape[0], zi.shape[0], dtype, "cuda", restarts=restarts)
    pert = torch.as_tensor(np.random.default_rng(3).normal(size=(plan.p, restarts - 1, plan.s_max)),
                           dtype=dtype, device="cuda")
    step.load(reg.vs.latent_vector(names), x_pad, rows, zi, pert)
    return reg, x, y, step


def _graphed_step_matches_eager_step(dtype, dense, restarts=1):
    # The same bodies from the same buffers: replayed graphs and the eager
    # run give the same bits.
    from gpar_torch.models.fused import _cusolver
    from gpar_torch.models.graphs import GraphedStep

    _, _, _, step = _small_step(dtype, dense, restarts)
    twin = step.clone()
    with _cusolver("cuda"):
        graphs = GraphedStep(step)
        eager = Eager(twin)
        GK.reset_counters()
        for name in ("layer_init", "step", "commit", "step", "trial", "layer_finish", "layer_init"):
            graphs(name)
            eager(name)
        torch.cuda.synchronize()
    for a, b in zip(step._buffers(), twin._buffers()):
        assert torch.equal(a, b)
    assert graphs.replays == 7
    counts = GK.counters()
    # Replays count their launches like the eager run does.
    assert counts["gram_kernel_launches"] > 0 and counts["gram_plain_cuda_calls"] == 0
    assert counts["gram_bwd_kernel_launches"] == counts["gram_autograd_calls"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_graphed_layer_step_matches_eager_step(dtype):
    _need_cuda()
    _graphed_step_matches_eager_step(dtype, dense=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_graphed_dense_layer_step_matches_eager_step(dtype):
    _need_cuda()
    # No inducing points: the (rows, rows) Gram and its factorisation
    # through the on-device ladder, captured.
    _graphed_step_matches_eager_step(dtype, dense=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_graphed_restart_step_matches_eager_step(dense):
    _need_cuda()
    # Three starts per layer: the batched L-BFGS's bodies and the best-of
    # selection in layer_finish, captured; every Gram a batched launch.
    _graphed_step_matches_eager_step(torch.float64, dense, restarts=3)
    assert GK.gram_batched_kernel_launches > 0 and GK.gram_bwd_batched_kernel_launches > 0


def _batched_tree(B, npdt, device, d):
    """A gated tree of ``B`` elements: every hyperparameter with a leading
    batch axis."""
    from gpar_torch.ops.kernels import EQ, RQ, Linear

    r = np.random.default_rng(B)

    def P(a):
        return torch.as_tensor(np.asarray(a, npdt), device=device)

    gin = P((np.arange(d) < 2).astype(float))
    gout = P((np.arange(d) >= 2).astype(float))
    k = (P(r.uniform(0.5, 2, B)) * EQ().stretch(P(r.uniform(0.5, 3, (B, d))))).gate(gin)
    k = k + Linear().stretch(P(r.uniform(3, 9, (B, d)))).gate(gout)
    return k + P(r.uniform(0.5, 1.5, B)) * RQ(P(r.uniform(0.3, 2, B))).stretch(P(r.uniform(1, 4, (B, d))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_cuda_batched_backward_kernel_matches_plain(dtype, tol):
    _need_cuda()
    # A batch of per-element trees (the restarts' Grams): forward and
    # backward against their plain versions, element by element, with
    # every operand batched and with either one shared (its gradient the
    # sum over the batch); a second launch gives the same bits.
    npdt = np.float32 if dtype == torch.float32 else np.float64
    dev = torch.device("cuda")
    B, d = 5, 9
    tree = _batched_tree(B, npdt, dev, d)
    x, y = _inputs(d, npdt, n=300, m=133)
    prep = GK.prepare_terms(tree, torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
    assert prep[2].ndim == prep[3].ndim == 3 and prep[4].shape == (B, 7)
    g = torch.as_tensor(np.random.default_rng(9).normal(size=(B, 300, 133)).astype(npdt), device=dev)
    for layout in ("both", "left shared", "right shared"):
        kinds, dims, xf, yf, par = prep
        if layout == "left shared":
            xf = xf[0].contiguous()
        elif layout == "right shared":
            yf = yf[0].contiguous()
        case = (kinds, dims, xf, yf, par)
        launches = (GK.gram_batched_kernel_launches, GK.gram_bwd_batched_kernel_launches)
        K = GK.gram_kernel_launch(*case)
        got = GK.gram_bwd_kernel_launch(*case, g)
        again = GK.gram_bwd_kernel_launch(*case, g)
        torch.cuda.synchronize()
        assert (GK.gram_batched_kernel_launches - launches[0],
                GK.gram_bwd_batched_kernel_launches - launches[1]) == (1, 2)
        fwd_tol = 1e-5 if dtype == torch.float32 else 1e-12
        torch.testing.assert_close(K, GK.gram_terms_plain(*case), rtol=fwd_tol, atol=fwd_tol, msg=layout)
        want = GK.gram_terms_plain_vjp(*case, g)
        for a, b, c in zip(got, again, want):
            assert a.shape == c.shape and torch.equal(a, b), layout
            assert float((a - c).abs().max()) <= tol * max(float(c.abs().max()), 1e-30), layout


@pytest.mark.cuda
def test_cuda_graphed_restart_fit_equals_eager_fit():
    _need_cuda()
    reg, x, y, _ = _small_step(torch.float64)
    z0 = reg.vs.snapshot()
    normals = list(np.random.default_rng(5).normal(
        size=(reg.p, 2, build_scan_fit_plan(reg, reg.vs.select(None)).s_max)))
    reg.fit(x, y, iters=5, restarts=3, restart_normals=normals)
    graphed = (reg.last_fit_report, reg.vs.snapshot())
    reg.vs.restore(z0)
    reg.fit(x, y, iters=5, restarts=3, restart_normals=normals, cuda_graphs=False)
    eager = (reg.last_fit_report, reg.vs.snapshot())
    assert graphed[0]["graph_replays"] > 0 and eager[0]["graph_replays"] == 0
    np.testing.assert_array_equal(graphed[0]["layer_nll"], eager[0]["layer_nll"])
    for k, v in eager[1].items():
        np.testing.assert_array_equal(graphed[1][k], v)


@pytest.mark.cuda
def test_cuda_graphed_fit_equals_eager_fit():
    _need_cuda()
    reg, x, y, _ = _small_step(torch.float64)
    z0 = reg.vs.snapshot()
    reg.fit(x, y, iters=5)
    graphed = (reg.last_fit_report, reg.vs.snapshot())
    reg.vs.restore(z0)
    reg.fit(x, y, iters=5, cuda_graphs=False)
    eager = (reg.last_fit_report, reg.vs.snapshot())
    assert graphed[0]["graph_replays"] > 0 and eager[0]["graph_replays"] == 0
    np.testing.assert_array_equal(graphed[0]["layer_nll"], eager[0]["layer_nll"])
    for k, v in eager[1].items():
        np.testing.assert_array_equal(graphed[1][k], v)


def _greedy_chain(n=48, seed=5):
    """A chain whose greedy order is [2, 0, 1], with missing outputs."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 10.0, n)
    a = np.sin(x) + 0.3 * rng.standard_normal(n)
    y = np.stack([2.0 * a + 0.05 * rng.standard_normal(n), rng.standard_normal(n), a], axis=1)
    y[rng.permutation(n)[:5], 0] = np.nan
    y[rng.permutation(n)[:9], 1] = np.nan
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_greedy_scorer_matches_cpu(dense):
    # The batched candidate scorer on the card (every Gram one batched
    # launch of the forward kernel, every gradient one of the backward)
    # against the CPU (the plain versions), float64: the same order and the
    # same per-position NLLs to 1e-6.
    _need_cuda()
    x, y = _greedy_chain()
    kw = dict(noise=0.1, compat=False, nonlinear=True, linear_scale=10.0)
    if not dense:
        kw["x_ind"] = np.linspace(0.0, 10.0, 7)
    out = {}
    for dev in ("cuda", "cpu"):
        reg = GPARRegressor(**kw, device=dev, dtype=torch.float64)
        reg.condition(x, y)
        GK.reset_counters()
        order = reg._greedy_order(8)
        c = GK.counters()
        out[dev] = (order, [p["nll"] for p in reg.last_greedy_report["positions"]])
        if dev == "cuda":
            assert c["gram_batched_kernel_launches"] > 0 and c["gram_bwd_batched_kernel_launches"] > 0
            assert c["gram_eval_cuda_calls"] == 0 and c["gram_plain_cuda_calls"] == 0
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def _served(dense, replace=True):
    """A small float64 model on the card, fitted, and its test inputs."""
    x, y, x_test = chain_data(n=60, p=3, seed=2, n_test=12)
    kw = dict(bench_kwargs(n_ind=8), replace=replace)
    if dense:
        kw["x_ind"] = None
    reg = GPARRegressor(**kw, device="cuda", dtype=torch.float64)
    reg.fit(x, y, iters=3)
    return reg, x, y, x_test


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("replace", [True, False])
def test_cuda_cached_serving_equals_uncached(dense, replace):
    # The same bits from the cached factors, and fewer Grams: no Kmm and Kmn
    # (sparse) or K (dense) per layer.
    from gpar_torch.config import config

    _need_cuda()
    reg, x, y, x_test = _served(dense, replace)
    normals = np.random.default_rng(3).standard_normal((reg.p, 5, len(x_test)))
    assert reg.precompute()
    runs = {}
    for cached in (True, False):
        config.posterior_cache = cached
        try:
            GK.reset_counters()
            pred = reg.predict(x_test, num_samples=5, credible_bounds=True, normals=normals)
            launches = GK.counters()["gram_kernel_launches"]
            score = reg.logpdf(x[:20], y[:20], posterior=True)
        finally:
            config.posterior_cache = True
        runs[cached] = (pred, launches, score)
    for a, b in zip(runs[True][0], runs[False][0]):
        np.testing.assert_array_equal(a, b)
    assert runs[True][2] == runs[False][2]
    saved = reg.p * (1 if dense else 2)
    if replace:
        assert runs[True][1] == runs[False][1] - saved


@pytest.mark.cuda
def test_cuda_tensor_inputs_that_require_grad():
    _need_cuda()
    reg, x, y, x_test = _served(False)
    xt, yt = (torch.tensor(a, device="cuda", requires_grad=True) for a in (x, y))
    reg.condition(xt, yt)
    normals = np.zeros((reg.p, 2, len(x_test)))
    got = reg.predict(torch.tensor(x_test, device="cuda", requires_grad=True), num_samples=2,
                      normals=torch.tensor(normals, device="cuda", requires_grad=True))
    want = reg.predict(x_test, num_samples=2, normals=normals)
    np.testing.assert_array_equal(got, want)
    score = reg.logpdf(xt, yt, posterior=True)
    assert score.ndim == 0 and score.device.type == "cuda" and not score.requires_grad
    assert float(score) == reg.logpdf(x, y, posterior=True)


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip_predicts_the_same_bits(tmp_path):
    from gpar_torch.utils import checkpoint

    _need_cuda()
    reg, x, y, x_test = _served(False)
    normals = np.random.default_rng(4).standard_normal((reg.p, 4, len(x_test)))
    want = reg.predict(x_test, num_samples=4, normals=normals)
    checkpoint.save(reg, str(tmp_path / "reg.pkl"))
    back = checkpoint.load(str(tmp_path / "reg.pkl"))
    assert back.device.type == "cuda" and back._factor_cache is None
    np.testing.assert_array_equal(back.predict(x_test, num_samples=4, normals=normals), want)


@pytest.mark.cuda
def test_cuda_warmup_then_fit_captures_nothing():
    from gpar_torch.models import graphs

    _need_cuda()
    graphs.clear_cache()
    x, y, x_test = chain_data(n=60, p=3, seed=2, n_test=12)
    kw = bench_kwargs(n_ind=8)
    rep = GPARRegressor(**kw, device="cuda", dtype=torch.float64).warmup(50, 3, n_test=10, iters=2)
    assert set(rep["seconds"]) == {"fit", "predict", "fit_predict", "logpdf"}
    reg = GPARRegressor(**kw, device="cuda", dtype=torch.float64)
    reg.fit_predict(x, y, x_test, iters=2, num_samples=3)
    assert reg.last_fit_report["capture_s"] == 0.0 and reg.last_fit_report["graph_replays"] > 0
    graphs.clear_cache()


@pytest.mark.cuda
def test_cuda_graph_cache_keeps_what_the_byte_budget_holds():
    from gpar_torch.config import config
    from gpar_torch.models import graphs

    _need_cuda()
    graphs.clear_cache()
    x, y, _ = chain_data(n=60, p=3, seed=2)
    reg = GPARRegressor(**dict(bench_kwargs(), x_ind=None), device="cuda", dtype=torch.float64)
    reg.fit(x, y, iters=2)
    one = graphs.cached_bytes()
    assert one > 0 and len(graphs._CACHE) == 1
    old = config.graph_cache_max_bytes
    config.graph_cache_max_bytes = one + one // 2
    try:
        reg.fit(x, y, iters=3)
        assert len(graphs._CACHE) == 1 and [k[5] for k in graphs._CACHE] == [3]
        assert graphs.cached_bytes() <= config.graph_cache_max_bytes
    finally:
        config.graph_cache_max_bytes = old
        graphs.clear_cache()
