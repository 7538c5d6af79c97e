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
from gpar_torch.models.fused import Eager, build_scan_fit_plan  # noqa: E402
from gpar_torch.ops import gram_kernel as GK  # noqa: E402

from .torch_cases import (  # noqa: E402
    CASES, FUSED, TorchFW, _inputs, bench_kwargs, chain_data, scan_step,
)


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
    reg, step = scan_step("cuda", dtype, dense, restarts)
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


def _card_scan_fit(dense, rule, graphed, eps=None, w=None, restarts=1):
    """``(results, stats)`` of the float64 scan fit of :func:`scan_step`'s
    model on the card, 5 iterations a layer: graphed or eager, its
    evaluations on the jitter rule ``rule`` (``"first_rung"`` or the ladder,
    ``"device"``), with the first jitter ``eps``."""
    import gpar_torch
    from gpar_torch.models.fused import _cusolver, run_scan_fit
    from gpar_torch.models.graphs import GraphedStep
    from gpar_torch.params.lbfgs import new_stats

    old = gpar_torch.config.epsilon
    gpar_torch.config.epsilon = old if eps is None else eps
    try:
        _, step = scan_step("cuda", torch.float64, dense, restarts, rule, w)
        stats = new_stats()
        with _cusolver("cuda"):
            run = GraphedStep(step) if graphed else Eager(step)
            out = run_scan_fit(step, run, 5, stats)
        torch.cuda.synchronize()
    finally:
        gpar_torch.config.epsilon = old
    return [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in out], stats


@pytest.mark.cuda
@pytest.mark.parametrize("dense, restarts", [(False, 1), (True, 1), (True, 2)],
                         ids=["sparse", "dense", "dense-restarts"])
@pytest.mark.parametrize("forced", [False, True], ids=["holds", "repaired"])
def test_cuda_graphed_first_rung_fit_equals_the_eager_ladder_fit(dense, restarts, forced):
    # The graphed fit that factors at the first rung against the eager fit
    # on the full ladder: the same bits.  Forced: a negative first jitter
    # (and, dense, output 1's noise weighted down to nothing) fails some
    # first-rung factorisations, whose layers run again eagerly on the
    # ladder between the replays.
    _need_cuda()
    eps, w = None, None
    if forced:
        eps = -1e-4 if dense else -1e-1
        if dense:
            w = np.ones((100, 3))
            w[:, 1] = 1e30
    got, stats = _card_scan_fit(dense, "first_rung", True, eps, w, restarts)
    want, ladder = _card_scan_fit(dense, "device", False, eps, w, restarts)
    assert (stats["ladder_repairs"] > 0) == forced and ladder["ladder_repairs"] == 0
    assert stats["ladder_escalations"] == ladder["ladder_escalations"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("fix", [True, False])
def test_cuda_unroll_fit_launches_both_kernels(dense, fix):
    # fit(fused="unroll") evaluates GPAR.logpdf eagerly through the GP core:
    # every Gram through the forward kernel, every Gram under autograd back
    # through the backward kernel, no plain-route Gram, no gram_eval.
    _need_cuda()
    x, y, _ = chain_data(n=100, p=3, seed=0)
    y[::7, 2] = np.nan
    kw = dict(bench_kwargs(n_ind=8), **({"x_ind": None} if dense else {}))
    reg = GPARRegressor(**kw, device="cuda", dtype=torch.float64)
    GK.reset_counters()
    reg.fit(x, y, iters=3, fix=fix, fused="unroll")
    torch.cuda.synchronize()
    c = GK.counters()
    assert reg.last_fit_report["fused"] == "unroll"
    assert np.all(np.isfinite(reg.last_fit_report["layer_nll"]))
    assert c["gram_kernel_launches"] > 0 and c["gram_plain_cuda_calls"] == 0
    assert c["gram_eval_cuda_calls"] == 0
    assert c["gram_bwd_kernel_launches"] == c["gram_autograd_calls"] > 0


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
            # A first predict captures the route's tail graph, whose warm-up
            # run launches its Grams once more; the predict below replays it.
            reg.predict(x_test, num_samples=5, normals=normals)
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


def _tail_args(reg, x_test, num_samples=5, seed=2, w=None):
    """The cached tail's arguments as the estimator's cached predict makes
    them on the card (test rows padded to their bucket and masked)."""
    from gpar_torch.config import bucket_rows

    names = reg.vs.select(None)
    plan = reg._scan_fit_plan(names)
    _, rows = reg._bucket_fit_inputs(plan)
    z = reg.vs.latent_vector(names)
    nt, nb = len(x_test), bucket_rows(len(x_test))
    up = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")  # noqa: E731
    x_t = up(np.pad(np.asarray(x_test).reshape(nt, -1), ((0, nb - nt), (0, 0))))
    w_t = up(np.ones((reg.p, nb))) if w is None else w
    normals = up(np.random.default_rng(seed).standard_normal((reg.p, num_samples, nb)))
    return plan, (z, reg._posterior_factors(plan, z), x_t, w_t, normals, rows,
                  up(np.arange(nb) < nt))


def _tail_keys():
    from gpar_torch.models import graphs

    return [k for k in graphs._CACHE if k[0] == "tail"]


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("latent", [False, True])
def test_cuda_tail_graph_replay_equals_the_eager_tail(dense, latent):
    # Captured on the first call, replayed on the next: the same bits as the
    # eager cached tail, and as many Gram launches as it makes.
    from gpar_torch.models import fused, graphs

    _need_cuda()
    graphs.clear_cache()
    try:
        reg, _, _, x_test = _served(dense)
        eager = fused.make_scan_cached_tail(reg._scan_fit_plan(reg.vs.select(None)), latent,
                                            rows_traced=True)
        for seed in (2, 3):
            plan, args = _tail_args(reg, x_test, seed=seed)
            GK.reset_counters()
            got = graphs.graphed_tail(plan, latent, *args)
            replayed = GK.counters()["gram_kernel_launches"]
            GK.reset_counters()
            want = eager(*args)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            if seed == 3:  # a replay
                assert replayed == GK.counters()["gram_kernel_launches"] == 2 * reg.p
        assert len(_tail_keys()) == 1
    finally:
        graphs.clear_cache()


@pytest.mark.cuda
def test_cuda_tail_graph_repairs_a_failed_first_rung():
    # Duplicate test inputs, layer 1's noise weighted down to nothing and
    # the jitter lowered to -1e-4 (as in tests/test_torch_serving.py): that
    # layer's first rung fails in the replay and its draws are made anew,
    # the eager tail's bits.
    import gpar_torch
    from gpar_torch.config import bucket_rows
    from gpar_torch.models import fused, graphs

    _need_cuda()
    graphs.clear_cache()
    reg, _, _, x_test = _served(False)
    x_test[:4] = x_test[0]
    w = torch.ones((reg.p, bucket_rows(len(x_test))), dtype=torch.float64, device="cuda")
    w[1] = 1e30
    plan, args = _tail_args(reg, x_test, w=w)
    old, repaired = gpar_torch.config.epsilon, []
    real = fused.CachedTailBody.repair_layer
    fused.CachedTailBody.repair_layer = (lambda self, pi, *a: repaired.append(pi)
                                         or real(self, pi, *a))
    gpar_torch.config.epsilon = -1e-4
    try:
        got = graphs.graphed_tail(plan, False, *args)
        want = fused.make_scan_cached_tail(plan, False, rows_traced=True)(*args)
    finally:
        gpar_torch.config.epsilon = old
        fused.CachedTailBody.repair_layer = real
        graphs.clear_cache()
    assert repaired == [1] and bool(torch.isfinite(got[0]).all())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_tail_graph_captures_once_per_key():
    # The first predict at a key captures, the next replays; another number
    # of samples or another test bucket is another key.
    from gpar_torch.models import graphs

    _need_cuda()
    graphs.clear_cache()
    try:
        reg, _, _, x_test = _served(False)
        assert reg.precompute()
        reg.predict(x_test, num_samples=5)
        (key,) = _tail_keys()
        entry = graphs._CACHE[key][1]
        reg.predict(x_test, num_samples=5)
        assert _tail_keys() == [key] and graphs._CACHE[key][1] is entry
        reg.predict(x_test, num_samples=7)
        assert len(_tail_keys()) == 2
        reg.predict(np.linspace(0.2, 9.8, 100), num_samples=7)
        assert len(_tail_keys()) == 3
    finally:
        graphs.clear_cache()


@pytest.mark.cuda
def test_cuda_tail_graph_is_evicted_by_the_byte_budget(monkeypatch):
    # A real tail capture pins bytes on the card; then, with each new
    # entry's pinned bytes stated (a capture's reading moves with the
    # allocator's rounding), steps and tails share the budget: the least
    # recently used goes, whichever kind it is, its graphs reset.
    from gpar_torch.config import config
    from gpar_torch.models import graphs

    _need_cuda()
    graphs.clear_cache()
    reg, x, y, x_test = _served(False)
    assert reg.precompute()
    reg.predict(x_test, num_samples=5)
    (key,) = _tail_keys()
    assert graphs._CACHE[key][2] > 0
    graphs.clear_cache()
    reserved, pending = [0], [0]
    real = graphs.GraphedStep

    def stated(step):
        reserved[0] += pending[0]
        return real(step)

    monkeypatch.setattr(graphs, "GraphedStep", stated)
    monkeypatch.setattr(graphs, "_reserved", lambda device: reserved[0])
    monkeypatch.setattr(config, "graph_cache_max_bytes", 100)
    try:
        kinds = []
        for nbytes, call in ((40, lambda: reg.fit(x, y, iters=3)),
                             (50, lambda: reg.predict(x_test, num_samples=5)),
                             (30, lambda: reg.predict(x_test, num_samples=7)),
                             (60, lambda: reg.fit(x, y, iters=4))):
            pending[0] = nbytes
            call()
            kinds.append([(k[0] == "tail", e[2]) for k, e in graphs._CACHE.items()])
        assert kinds == [[(False, 40)], [(False, 40), (True, 50)], [(True, 50), (True, 30)],
                         [(True, 30), (False, 60)]]
        assert graphs.cached_bytes() == 90
    finally:
        graphs.clear_cache()


def _uncached_args(reg, x_test, num_samples=5, seed=2, w=None):
    """The uncached tail's arguments as the estimator's predict makes them
    on the card: the bucketed training inputs in place of the factors."""
    plan, (z, _, *rest) = _tail_args(reg, x_test, num_samples, seed, w)
    return plan, (z, reg._bucket_fit_inputs(plan)[0], *rest)


def _uncached_keys():
    from gpar_torch.models import graphs

    return [k for k in graphs._CACHE if k[0] == "uncached_tail"]


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("latent", [False, True])
def test_cuda_uncached_tail_graph_replay_equals_the_eager_tail(dense, latent):
    # Captured on the first call, replayed on the next: every layer's
    # training factor and sampling factor at the first rung in the graph,
    # the same bits as the eager uncached tail, and as many Gram launches.
    from gpar_torch.models import fused, graphs

    _need_cuda()
    graphs.clear_cache()
    try:
        reg, _, _, x_test = _served(dense)
        for seed in (2, 3):
            plan, args = _uncached_args(reg, x_test, seed=seed)
            GK.reset_counters()
            got = graphs.graphed_uncached_tail(plan, reg.x_ind, latent, *args)
            replayed = GK.counters()["gram_kernel_launches"]
            GK.reset_counters()
            want = fused.make_scan_predict_tail(plan, reg.x_ind, latent, rows_traced=True)(*args)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            if seed == 3:  # a replay
                grams = (3 if dense else 4) * reg.p  # K or Kmm and Kmn; Kxt or Kmt; Ktt
                assert replayed == GK.counters()["gram_kernel_launches"] == grams
        assert len(_uncached_keys()) == 1 and not _tail_keys()
    finally:
        graphs.clear_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_uncached_tail_graph_runs_the_eager_tail_where_a_first_rung_failed(dense):
    # The forced failure of the cached tail's test (layer 1's sampling
    # factor at the jitter -1e-4): the replay's draws are dropped and the
    # whole eager tail runs again, its bits.
    import gpar_torch
    from gpar_torch.config import bucket_rows
    from gpar_torch.models import fused, graphs

    _need_cuda()
    graphs.clear_cache()
    reg, _, _, x_test = _served(dense)
    x_test[:4] = x_test[0]
    w = torch.ones((reg.p, bucket_rows(len(x_test))), dtype=torch.float64, device="cuda")
    w[1] = 1e30
    plan, args = _uncached_args(reg, x_test, w=w)
    old, repaired = gpar_torch.config.epsilon, []
    real = fused.UncachedTailBody.repair
    fused.UncachedTailBody.repair = lambda self, *a: repaired.append(1) or real(self, *a)
    gpar_torch.config.epsilon = -1e-4
    try:
        got = graphs.graphed_uncached_tail(plan, reg.x_ind, False, *args)
        want = fused.make_scan_predict_tail(plan, reg.x_ind, False, rows_traced=True)(*args)
    finally:
        gpar_torch.config.epsilon = old
        fused.UncachedTailBody.repair = real
        graphs.clear_cache()
    assert repaired == [1] and bool(torch.isfinite(got[0]).all())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_uncached_tail_graph_captures_once_per_key(monkeypatch):
    # With the factor cache off, the first predict at a key captures, the
    # next replays; another number of samples or another test bucket is
    # another key.
    from gpar_torch.config import config
    from gpar_torch.models import graphs

    _need_cuda()
    monkeypatch.setattr(config, "posterior_cache", False)
    graphs.clear_cache()
    try:
        reg, _, _, x_test = _served(True)
        assert not reg.precompute()
        reg.predict(x_test, num_samples=5)
        (key,) = _uncached_keys()
        entry = graphs._CACHE[key][1]
        reg.predict(x_test, num_samples=5)
        assert _uncached_keys() == [key] and graphs._CACHE[key][1] is entry
        assert entry.replays == 2
        reg.predict(x_test, num_samples=7)
        assert len(_uncached_keys()) == 2
        reg.predict(np.linspace(0.2, 9.8, 100), num_samples=7)
        assert len(_uncached_keys()) == 3 and not _tail_keys()
    finally:
        graphs.clear_cache()


@pytest.mark.cuda
def test_cuda_uncached_tail_graph_is_evicted_by_the_byte_budget(monkeypatch):
    # A real uncached tail capture pins bytes on the card; then, with each
    # new entry's pinned bytes stated, it shares the budget with the steps
    # and the cached tails: the least recently used goes, its graphs reset.
    from gpar_torch.config import config
    from gpar_torch.models import graphs

    _need_cuda()
    graphs.clear_cache()
    reg, x, y, x_test = _served(True)
    monkeypatch.setattr(config, "posterior_cache", False)
    reg.predict(x_test, num_samples=5)
    (key,) = _uncached_keys()
    assert graphs._CACHE[key][2] > 0
    graphs.clear_cache()
    reserved, pending = [0], [0]
    real = graphs.GraphedStep

    def stated(step):
        reserved[0] += pending[0]
        return real(step)

    monkeypatch.setattr(graphs, "GraphedStep", stated)
    monkeypatch.setattr(graphs, "_reserved", lambda device: reserved[0])
    monkeypatch.setattr(config, "graph_cache_max_bytes", 100)

    def cached_predict(num_samples):
        monkeypatch.setattr(config, "posterior_cache", True)
        reg.predict(x_test, num_samples=num_samples)
        monkeypatch.setattr(config, "posterior_cache", False)

    try:
        kinds = []
        for nbytes, call in ((40, lambda: reg.fit(x, y, iters=3)),
                             (50, lambda: reg.predict(x_test, num_samples=5)),
                             (30, lambda: cached_predict(5)),
                             (60, lambda: reg.predict(x_test, num_samples=7))):
            pending[0] = nbytes
            call()
            kinds.append([(k[0] if k[0] in ("tail", "uncached_tail") else "step", e[2])
                          for k, e in graphs._CACHE.items()])
        assert kinds == [[("step", 40)], [("step", 40), ("uncached_tail", 50)],
                         [("uncached_tail", 50), ("tail", 30)],
                         [("tail", 30), ("uncached_tail", 60)]]
        assert graphs.cached_bytes() == 90
    finally:
        graphs.clear_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_virtual_mesh_matches_cpu(dense):
    # A 2-shard virtual mesh of the card (graphed fit, prior and posterior
    # scores, predict) against the CPU route on the same inputs, float64;
    # every Gram of the mesh route through the kernels, none through
    # gram_eval.
    import gpar_torch
    from gpar_torch.parallel import make_mesh

    _need_cuda()
    x, y, x_test = chain_data(n=60, p=3, seed=2, n_test=12)
    y[[4, 9], 1] = np.nan
    kw = dict(bench_kwargs(n_ind=8), **({"x_ind": None, "replace": False} if dense else {}))
    normals = np.random.default_rng(3).standard_normal((3, 5, len(x_test)))
    out = []
    for device in ("cuda", "cpu"):
        reg = GPARRegressor(**kw, device=device, dtype=torch.float64)
        mesh = make_mesh(2, devices=[torch.device(device)] * 2)
        GK.reset_counters()
        with gpar_torch.use_mesh(mesh, min_rows=8):
            reg.fit(x, y, iters=3)
            res = [reg.last_fit_report["layer_nll"], reg.logpdf(x, y), reg.logpdf(x, y, posterior=True),
                   reg.predict(x_test, num_samples=5, normals=normals)]
        counts = GK.counters()
        out.append(res)
        if device == "cuda":
            assert reg.last_fit_report["graph_replays"] > 0
            assert counts["gram_kernel_launches"] > 0 and counts["gram_bwd_kernel_launches"] > 0
            assert counts["gram_eval_cuda_calls"] == 0 and counts["gram_plain_cuda_calls"] == 0
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("cached", [True, False])
def test_cuda_rq_ancestral_predict_matches_cpu(cached, monkeypatch):
    # The exchange-rate route at a small size: RQ kernels, a gap imputed,
    # replace=False per-sample chains in chunks of 4 (the Grams with a
    # sample axis through the kernel's RQ branch), the factors cached or
    # computed in the tail; the card's fit and predictive equal the CPU's
    # within rounding, float64.
    import gpar_torch

    _need_cuda()
    monkeypatch.setattr(gpar_torch.config, "posterior_cache", cached)
    monkeypatch.setattr(gpar_torch.config, "predict_sample_chunk", 4)
    x, y, x_test = chain_data(n=60, p=3, seed=4, n_test=12)
    y[10:22, 1] = np.nan
    kw = dict(bench_kwargs(), x_ind=None, rq=True, replace=False)
    normals = np.random.default_rng(5).standard_normal((3, 6, len(x_test)))
    out = []
    for device in ("cuda", "cpu"):
        reg = GPARRegressor(**kw, device=device, dtype=torch.float64)
        reg.fit(x, y, iters=3)
        assert reg.precompute() is cached
        GK.reset_counters()
        res = reg.predict(x_test, num_samples=6, credible_bounds=True, normals=normals)
        out.append([reg.last_fit_report["layer_nll"], *res])
        rep = reg.last_predict_report
        assert rep["sample_chunk"] == 4 and rep["sample_factor_batches"] == 3 * 2
        if device == "cuda":
            assert GK.counters()["gram_batched_kernel_launches"] > 0
            assert GK.counters()["gram_eval_cuda_calls"] == 0
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
