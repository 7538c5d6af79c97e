"""The scan-fused fit and predict tail of gpar_torch (``models/fused.py``)
against gpar_tpu's scan path, float64, on the CPU.

The benchmark's configuration scaled down (p=3, n=100, 8 inducing points,
NaNs in the later outputs).  Tolerances:

- plan arrays and bucketed row arrays: exact;
- one layer's NLL, ``Kmm``, ``Kmn``, ``beta`` at the same latents: 1e-10;
- the whole fit: at ``iters=0`` the layer NLLs to 1e-10; at ``iters=5``
  the layer NLLs to 1e-6 and every latent to 1e-6 / 1e-8 (both run the
  same L-BFGS decisions on the same objective, in another summation
  order); the same against the port's per-layer driver;
- the predict tail against JAX's with the same standard normals: 1e-8,
  latent or not, unit or non-unit test weights (latent draws through
  their covariance, ``test_torch_common.close_tail``);
- the bucketed form against the exact-shape form: 1e-12;
- the device-state L-BFGS against JAX's ``lbfgs_minimize``: 1e-10;
- the on-device Cholesky ladder against the host ladder: bit for bit.
"""

import numpy as np
import pytest

from .test_torch_common import (
    bench_kwargs, chain_data, close, close_tail, jax, jax_chain_normals, jnp, np_, torch,
)

import gpar_tpu.models.fused as JF  # noqa: E402
import gpar_tpu.ops.linalg as JL  # noqa: E402
from gpar_tpu.config import bucket_rows as j_bucket_rows  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402
from gpar_tpu.params.lbfgs import lbfgs_minimize as j_lbfgs  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
import gpar_torch.ops.linalg as TL  # noqa: E402
from gpar_torch.config import bucket_rows  # noqa: E402
from gpar_torch import GPARRegressor as TReg  # noqa: E402
from gpar_torch.params.lbfgs import iterate, lbfgs_minimize as t_lbfgs, new_stats  # noqa: E402

P, ITERS, S, NT = 3, 5, 8, 20


def _data():
    x, y, x_test = chain_data(n=100, p=P, seed=0, n_test=NT)
    r = np.random.default_rng(4)
    y[:, 1:][r.uniform(size=(100, P - 1)) < 0.12] = np.nan
    return x, y, x_test


@pytest.fixture(scope="module")
def fits():
    """JAX's scan fit at iters=0 and iters=5 (shared by the cases)."""
    x, y, x_test = _data()
    kw = bench_kwargs(n_ind=8)
    out = dict(x=x, y=y, x_test=x_test, kw=kw)
    for iters in (0, ITERS):
        rj = JReg(**kw)
        rj.fit(x, y, iters=iters)
        assert rj.last_fit_report["fused"]
        out[iters] = rj
    return out


def _pair(kw, x, y, impute=True):
    kw = dict(kw, impute=impute)
    rj, rt = JReg(**kw), TReg(**kw, device="cpu")
    for r in (rj, rt):
        r.condition(x, y)
        r._ensure_vars(r.p)
    return rj, rt


@pytest.mark.parametrize("impute", [True, False])
def test_plan_arrays_equal_jax(fits, impute):
    rj, rt = _pair(fits["kw"], fits["x"], fits["y"], impute)
    names = rt.vs.select(None)
    assert names == rj.vs.select(None)
    pj, pt = JF.build_scan_fit_plan(rj, names), TF.build_scan_fit_plan(rt, names)
    for f in ("m", "p", "W", "n", "s_max", "n_z", "sparse", "impute", "replace"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert sorted(pt.xs) == sorted(pj.xs)
    for k in pj.xs:
        a, b = np.asarray(pt.xs[k]), np.asarray(pj.xs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert TF.plan_static_fingerprint(pt) == JF.plan_static_fingerprint(pj)


@pytest.mark.parametrize("n, want", [(1, 64), (64, 64), (65, 128), (100, 128), (1024, 1216),
                                     (10_000, 11_840)])
def test_bucket_rows_equal_jax(n, want):
    assert bucket_rows(n) == j_bucket_rows(n) == want


@pytest.mark.parametrize("impute", [True, False])
def test_device_bucket_inputs_equal_jax(fits, impute):
    rj, rt = _pair(fits["kw"], fits["x"], fits["y"], impute)
    n_b = bucket_rows(rt.n)
    assert n_b == j_bucket_rows(rj.n) == 128
    xj, rows_j = JF.device_bucket_inputs(rj._x_np, rj._y_np, rj._w_np, n_b=n_b, impute=impute)
    xt, rows_t = TF.device_bucket_inputs(rt._x_np, rt._y_np, rt._w_np, n_b=n_b, impute=impute,
                                         device="cpu")
    np.testing.assert_array_equal(np_(xt), np_(xj))
    assert sorted(rows_t) == sorted(rows_j)
    host = TF.pad_plan_rows(TF.build_scan_fit_plan(rt, rt.vs.select(None)), n_b)
    for k in rows_j:
        np.testing.assert_array_equal(np_(rows_t[k]), np_(rows_j[k]), err_msg=k)
        np.testing.assert_array_equal(np_(rows_t[k]), host[k], err_msg=k)


def test_layer_nll_factors_match_jax(fits):
    rj, rt = _pair(fits["kw"], fits["x"], fits["y"])
    rt.load_latents(rj.vs.snapshot())
    names = rt.vs.select(None)
    pj, pt = JF.build_scan_fit_plan(rj, names), TF.build_scan_fit_plan(rt, names)
    r = np.random.default_rng(7)
    x_aug = np.concatenate([fits["x"][:, None], r.normal(size=(100, P))], axis=1)
    zi_aug = np.concatenate([np.linspace(0, 10, 8)[:, None], r.normal(size=(8, P))], axis=1)
    z_ext = np.r_[np.asarray(rj.vs.latent_vector(names)), 0.0]
    xs_t = TF.plan_tensors(pt, torch.float64, "cpu")
    eps = JL.resolve_epsilon(jnp.float64)
    for pi in range(P):
        lin_j = {k: jnp.asarray(v[pi]) for k, v in pj.xs.items()}
        lin_t = {k: v[pi] for k, v in xs_t.items()}
        nll_j, (Kmm_j, Kmn_j, beta_j) = JF._layer_nll_factors(
            pj, lin_j, jnp.asarray(z_ext), jnp.asarray(x_aug), jnp.asarray(zi_aug), eps)
        nll_t, (Kmm_t, Kmn_t, beta_t) = TF._layer_nll_factors(
            pt, lin_t, torch.as_tensor(z_ext), torch.as_tensor(x_aug), torch.as_tensor(zi_aug))
        close(nll_t, nll_j, rtol=1e-10)
        close(Kmm_t, Kmm_j, rtol=1e-10, atol=1e-14)
        close(Kmn_t, Kmn_j, rtol=1e-10, atol=1e-14)
        close(beta_t, beta_j, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("iters", [0, ITERS])
def test_scan_fit_matches_jax_scan_fit(fits, iters):
    rj = fits[iters]
    rt = TReg(**fits["kw"], device="cpu")
    rt.fit(fits["x"], fits["y"], iters=iters)
    rep, jrep = rt.last_fit_report, rj.last_fit_report
    assert rep["fused"] is True and rep["graph_replays"] == 0
    assert rep["layer_iters"].tolist() == np.asarray(jrep["layer_iters"]).tolist()
    if iters == 0:
        close(rep["layer_nll"], jrep["layer_nll"], rtol=1e-10)
        close(rep["layer_nll0"], jrep["layer_nll0"], rtol=1e-10)
        return
    close(rep["layer_nll"], jrep["layer_nll"], rtol=1e-6)
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    assert list(sj) == list(st)
    for k in sj:
        close(st[k], sj[k], rtol=1e-6, atol=1e-8)


def test_scan_fit_matches_per_layer_driver(fits):
    a, b = TReg(**fits["kw"], device="cpu"), TReg(**fits["kw"], device="cpu")
    a.fit(fits["x"], fits["y"], iters=ITERS)
    b.fit(fits["x"], fits["y"], iters=ITERS, fused=False)
    assert a.last_fit_report["fused"] and not b.last_fit_report["fused"]
    close(a.last_fit_report["layer_nll"], b.last_fit_report["layer_nll"], rtol=1e-6)
    close(a.last_fit_report["layer_nll0"], b.last_fit_report["layer_nll0"], rtol=1e-6)
    sa, sb = a.vs.snapshot(), b.vs.snapshot()
    for k in sb:
        close(sa[k], sb[k], rtol=1e-6, atol=1e-8)
    # One read per iteration and per backtracking trial and episode, one at the end.
    rep = a.last_fit_report
    assert rep["host_syncs"] == (int(np.sum(rep["layer_iters"])) + rep["linesearch_trials"]
                                 + rep["linesearch_episodes"] + 1)


def _tails(fits):
    rj = fits[ITERS]
    rt = TReg(**fits["kw"], device="cpu")
    rt.condition(fits["x"], fits["y"])
    rt.load_latents(rj.vs.snapshot())
    names = rt.vs.select(None)
    return rj, rt, names, JF.build_scan_fit_plan(rj, names), TF.build_scan_fit_plan(rt, names)


@pytest.mark.parametrize("unit_w", [True, False])
@pytest.mark.parametrize("latent", [False, True])
def test_predict_tail_matches_jax(fits, latent, unit_w):
    rj, rt, names, pj, pt = _tails(fits)
    key = jax.random.PRNGKey(11)
    xt = fits["x_test"][:, None]
    s = 2 * NT  # at least n_test draws: close_tail recovers latent factors from them
    w = np.ones((P, NT)) if unit_w else np.random.default_rng(12).uniform(0.5, 2.0, (P, NT))
    batch_j, mean_j = JF.make_scan_predict_tail(pj, rj.x_ind, latent)(
        rj.vs.latent_vector(names), rj.x, jnp.asarray(xt), jnp.asarray(w), jax.random.split(key, s))
    normals = jax_chain_normals(key, P, NT, num_samples=s)
    batch_t, mean_t = TF.make_scan_predict_tail(pt, rt.x_ind, latent)(
        rt.vs.latent_vector(names), rt.x, torch.as_tensor(xt), torch.as_tensor(w), torch.as_tensor(normals))
    assert tuple(batch_t.shape) == (s, NT, P) and tuple(mean_t.shape) == (NT, P)
    close_tail((batch_t, mean_t), (batch_j, mean_j), normals, latent)


def test_bucketed_forms_equal_exact_forms(fits):
    _, rt, names, _, pt = _tails(fits)
    z0 = rt.vs.latent_vector(names)
    x_pad, rows = rt._bucket_fit_inputs(pt)
    assert x_pad.shape[0] == 128
    exact = TF.make_scan_fit_body(pt, rt.x_ind, ITERS, 1e-9, 10)(z0, rt.x)
    bucketed = TF.make_scan_fit_body(pt, rt.x_ind, ITERS, 1e-9, 10, rows_traced=True)(z0, x_pad, rows)
    for a, b in zip(bucketed, exact):
        close(a, b, rtol=1e-12, atol=1e-13)

    z = exact[0]
    normals = torch.as_tensor(np.random.default_rng(2).standard_normal((P, S, NT)))
    xt = torch.as_tensor(fits["x_test"][:, None])
    w = torch.ones(P, NT, dtype=torch.float64)
    want = TF.make_scan_predict_tail(pt, rt.x_ind, False)(z, rt.x, xt, w, normals)
    nt_b = bucket_rows(NT)
    assert nt_b == 64
    pad = nt_b - NT
    mt = torch.as_tensor((np.arange(nt_b) < NT).astype(float))
    got = TF.make_scan_predict_tail(pt, rt.x_ind, False, rows_traced=True)(
        z, x_pad, torch.nn.functional.pad(xt, (0, 0, 0, pad)), torch.nn.functional.pad(w, (0, pad), value=1.0),
        torch.nn.functional.pad(normals, (0, pad)), rows, mt)
    close(got[0][:, :NT], want[0], rtol=1e-12, atol=1e-13)
    close(got[1][:NT], want[1], rtol=1e-12, atol=1e-13)


def test_lbfgs_matches_jax_with_backtracking_past_its_memory():
    # A stiff Rosenbrock from far away: the first trials overshoot
    # (backtracking) and the run outlasts a memory of 3 pairs.
    def rosen(lib):
        return lambda z: lib.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2 + (1.0 - z[:-1]) ** 2)

    z0 = np.array([-1.9, 2.2, -0.7, 1.4])
    for iters in (4, 12, 25):
        zj, fj, itj, _ = j_lbfgs(rosen(jnp), jnp.asarray(z0), iters=iters, memory=3)
        stats = new_stats()
        zt, ft, itt, _ = t_lbfgs(rosen(torch), torch.as_tensor(z0), iters=iters, memory=3, stats=stats)
        assert itt == int(itj) == iters
        close(zt, zj, rtol=1e-10, atol=1e-12)
        close(ft, fj, rtol=1e-10, atol=1e-12)
    assert stats["linesearch_trials"] > 0 and stats["linesearch_episodes"] > 0
    assert stats["host_syncs"] == itt + stats["linesearch_trials"] + stats["linesearch_episodes"]


@pytest.mark.parametrize("case", ["holds", "second-rung", "every-rung-fails"])
def test_ladder_on_device_equals_the_host_ladder(case):
    # The capture-safe ladder picks the rung the host ladder picks, with the
    # same factor and gradient bit for bit, and counts the factorisations
    # that needed more than the first rung (that it reads nothing back is
    # the meta-device test's).
    K = {
        "holds": np.array([[2.0, 0.3], [0.3, 1.0]]),
        "second-rung": np.array([[1.0, 0.3], [0.3, 0.09 - 1e-10]]),  # 1e-12 fails, 1e-9 holds
        "every-rung-fails": np.array([[1.0, 0.0], [0.0, -1.0]]),
    }[case]
    R = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 2)))

    def run(chol):
        Kt = torch.as_tensor(K).requires_grad_(True)
        L = chol(Kt)
        if not L.requires_grad:
            return L, None
        return L, torch.autograd.grad(torch.sum(L * R), Kt)[0]

    want = run(TL.safe_cholesky)
    ladder = TL.Jitter("device")
    got = run(ladder.cholesky)
    assert int(ladder.count) == (case != "holds")
    np.testing.assert_array_equal(np_(got[0]), np_(want[0]))
    if case == "every-rung-fails":
        assert np.isnan(np_(got[0])).all()
        return
    np.testing.assert_array_equal(np_(got[1]), np_(want[1]))
    close(got[0], JL.safe_cholesky(jnp.asarray(K)), rtol=1e-6, atol=1e-8)


def test_runner_commits_only_accepted_states_on_the_cpu(fits):
    # The host logic of the graph runner, through its CPU mode (the same
    # bodies, run eagerly): a candidate is committed only after its flags
    # are read; a line search that fails keeps the state and ends the layer.
    _, rt, names, _, pt = _tails(fits)
    x_pad, rows = rt._bucket_fit_inputs(pt)
    step = TF.ScanStep(pt, x_pad.shape[0], 8, torch.float64, "cpu")
    step.load(rt.vs.latent_vector(names), x_pad, rows, rt.x_ind)
    run = TF.Eager(step)
    run("layer_init")
    start = [b.clone() for b in step.opt.state]
    step.opt.c1 = 1e12  # no step can pass Armijo
    stats = new_stats()
    assert iterate(run, step.opt, 25, stats) == (True, 0)
    assert (stats["host_syncs"], stats["linesearch_episodes"], stats["linesearch_trials"]) == (27, 1, 25)
    st = step.opt.state
    np.testing.assert_array_equal(np_(st.z), np_(start[0]))
    np.testing.assert_array_equal(np_(st.f), np_(start[1]))
    assert int(st.it) == 1 and int(st.count) == 0
    step.opt.c1 = 1e-4
    run("layer_init")
    assert iterate(run, step.opt, 25, stats) == (False, 0)
    assert float(step.opt.state.f) < float(start[1]) and int(step.opt.state.count) == 1
    for a, b in zip(step.opt.state, step.opt.cand):
        np.testing.assert_array_equal(np_(a), np_(b))


def test_graph_cache_evicts_the_least_recently_used_step(fits, monkeypatch):
    # The capture is stubbed out (it needs the card); the keying, loading
    # and eviction are the cache's own.
    import gpar_torch.models.graphs as TGr

    class Captured:
        capture_s = 1.0

        def __init__(self, step):
            self.step = step

    monkeypatch.setattr(TGr, "GraphedStep", Captured)
    monkeypatch.setattr(TGr, "CACHE_CAP", 2)
    monkeypatch.setattr(TGr, "_CACHE", type(TGr._CACHE)())
    _, rt, names, _, pt = _tails(fits)
    x_pad, rows = rt._bucket_fit_inputs(pt)
    args = (rt.vs.latent_vector(names), x_pad, rows, torch.as_tensor(rt.x_ind))

    def get(iters):
        return TGr.graphed_step(pt, x_pad.shape[0], 8, torch.float64, "cpu", iters, 1e-9, 10, args)

    def same(a, b):
        return a[0] is b[0] and a[1] is b[1]

    first = get(1)
    hit = get(1)
    assert first[2] == 1.0 and hit[2] == 0.0 and same(hit, first) and hit[1].step is first[0]
    get(2)
    get(1)  # a hit moves key 1 to the back
    get(3)  # evicts key 2, the least recently used
    assert [k[5] for k in TGr._CACHE] == [1, 3]
    assert same(get(1), first) and not same(get(2), first)
    np.testing.assert_array_equal(np_(first[0].x_aug[:, :pt.m]), np_(x_pad))


def test_escalating_ladder_in_the_scan_fit_equals_the_driver(fits, monkeypatch):
    # A first jitter of -2 fails every factorisation and sends it to the
    # last, relative rung (rungs 2 and 3 are -2e3 and -2e6): the
    # scan step's on-device ladder and the per-layer driver's host ladder
    # take the same rungs.
    from gpar_torch.config import config as tconfig

    monkeypatch.setattr(tconfig, "epsilon", -2.0)
    a, b = TReg(**fits["kw"], device="cpu"), TReg(**fits["kw"], device="cpu")
    a.fit(fits["x"], fits["y"], iters=3)
    b.fit(fits["x"], fits["y"], iters=3, fused=False)
    assert a.last_fit_report["ladder_escalations"] > 0
    close(a.last_fit_report["layer_nll"], b.last_fit_report["layer_nll"], rtol=1e-6)
    sa, sb = a.vs.snapshot(), b.vs.snapshot()
    for k in sb:
        close(sa[k], sb[k], rtol=1e-6, atol=1e-8)


def test_unported_fit_options_raise(fits):
    # fused="unroll", "batched" and restarts are ported
    # (tests/test_torch_unroll.py, tests/test_torch_batched_fit.py,
    # tests/test_torch_restarts.py): the unrolled fit is the per-layer
    # driver's computation, reported as "unroll"; an unknown route raises;
    # "batched" refuses this sparse model with JAX's message.
    rt, driver = TReg(**fits["kw"], device="cpu"), TReg(**fits["kw"], device="cpu")
    rt.fit(fits["x"], fits["y"], iters=1, fused="unroll")
    driver.fit(fits["x"], fits["y"], iters=1, fused=False)
    assert rt.last_fit_report["fused"] == "unroll"
    np.testing.assert_array_equal(rt.last_fit_report["layer_nll"],
                                  driver.last_fit_report["layer_nll"])
    with pytest.raises(ValueError, match="fused"):
        rt.fit(fits["x"], fits["y"], iters=1, fused="scan")
    with pytest.raises(ValueError, match="dense"):
        rt.fit(fits["x"], fits["y"], iters=1, fused="batched")
    # The dense path (x_ind=None) is ported: it fits, as JAX's does.
    kw = dict(fits["kw"], x_ind=None)
    dense, jdense = TReg(**kw, device="cpu"), JReg(**kw)
    for r in (dense, jdense):
        r.fit(fits["x"], fits["y"], iters=1)
    close(dense.last_fit_report["layer_nll"], jdense.last_fit_report["layer_nll"], rtol=1e-8)
    sj, st = jdense.vs.snapshot(), dense.vs.snapshot()
    for k in sj:
        close(st[k], sj[k], rtol=1e-8, atol=1e-10)


def test_step_bodies_read_nothing_back_to_the_host(fits):
    # A CUDA graph capture refuses a host read.  On the meta device every
    # read of a value (item(), bool(), an index given as a 0-d tensor)
    # raises, so the step's bodies are run there.
    _, rt = _pair(fits["kw"], fits["x"], fits["y"])
    plan = TF.build_scan_fit_plan(rt, rt.vs.select(None))
    step = TF.ScanStep(plan, 128, 8, torch.float64, "meta")
    run = TF.Eager(step)
    for name in step.BODIES:
        run(name)
    with pytest.raises(RuntimeError):
        step.z_ext[step.layer[0]]
