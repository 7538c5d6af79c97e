"""The scan fit's first-rung factorisations (``ops.linalg.Jitter("first_rung")``)
against the on-device jitter ladder (``ops.linalg.Jitter("device")``),
float64, on the CPU.

- Where the first rung holds, the first-rung factor's value and gradient
  equal the ladder's bit for bit: the dense masked factors, the Titsias
  ``Kmm`` / ``LB`` pair, and both over a batch of restarts.
- A first rung forced to fail (a negative jitter) is repaired: the scan fit
  through ``fused.Eager`` gives the latents and per-layer results of the
  fit on the full ladder bit for bit, and runs again exactly the layers
  whose ladder escalated.
- ``layer_init``, ``step`` and ``trial`` factor each matrix once; the bodies
  that run before a repair write nothing that ``layer_init`` does not set
  anew.

This file imports neither JAX nor ``gpar_tpu``.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gpar_torch  # noqa: E402
import gpar_torch.models.fused as TF  # noqa: E402
import gpar_torch.ops.linalg as TL  # noqa: E402
from gpar_torch.params.lbfgs import new_stats  # noqa: E402

from .torch_cases import scan_step  # noqa: E402

ITERS = 5


def _spd(rng, n, batch=()):
    A = rng.normal(size=(*batch, n, n))
    return torch.as_tensor(A @ np.swapaxes(A, -1, -2) / n + 0.5 * np.eye(n))


def _dense(K, noise, jitter):
    n = K.shape[-1]
    mask = torch.as_tensor((np.arange(n) % 5 != 3).astype(float))
    r = torch.as_tensor(np.random.default_rng(8).normal(size=n))
    return TF._masked_dense_factors(K, r, mask, noise, 1e-6, jitter)


def _titsias(Kmm, Kmn, noise, jitter):
    n = Kmn.shape[-1]
    mask = torch.as_tensor((np.arange(n) % 4 != 1).astype(float))
    y = torch.as_tensor(np.random.default_rng(9).normal(size=n))
    knn = torch.sum(Kmn * Kmn, dim=-2) + 1.0
    return TL.titsias_factors(Kmm, Kmn, knn, y, torch.zeros_like(y), noise, mask=mask,
                              jitter=jitter)


def _case(kind, batch):
    """``(f, inputs)``: ``f(*inputs, jitter)`` and its inputs, which
    require a gradient."""
    rng = np.random.default_rng(5)
    B = (3,) if batch else ()
    noise = torch.as_tensor(rng.uniform(0.05, 0.2, size=(*B, 30)))
    if kind == "dense":
        return _dense, [_spd(rng, 30, B), noise]
    Kmm = _spd(rng, 6, B)
    Kmn = torch.as_tensor(rng.normal(size=(*B, 6, 30)))
    return _titsias, [Kmm, Kmn, noise]


@pytest.mark.parametrize("batch", [False, True], ids=["one", "restarts"])
@pytest.mark.parametrize("kind", ["dense", "titsias"])
def test_first_rung_equals_the_ladder_where_it_holds(kind, batch):
    # The same cholesky_ex of the same matrix: every output and the gradient
    # of a random projection of them, bit for bit.
    f, inputs = _case(kind, batch)

    def run(jitter):
        xs = [a.clone().requires_grad_(True) for a in inputs]
        outs = f(*xs, jitter)
        R = np.random.default_rng(1)
        loss = sum(torch.sum(o * torch.as_tensor(R.normal(size=o.shape))) for o in outs)
        return [o.detach() for o in outs], torch.autograd.grad(loss, xs)

    first, ladder = TL.Jitter("first_rung"), TL.Jitter("device")
    got = run(first)
    want = run(ladder)
    assert int(first.count) == int(ladder.count) == 0
    for a, b in zip(got[0] + list(got[1]), want[0] + list(want[1])):
        assert a.shape == b.shape and torch.equal(a, b)


def test_a_failed_first_rung_is_nan_and_counted_per_element():
    # Element 1 holds only at the second rung: the first rung gives NaN
    # there, counts it once, and leaves element 0 the ladder's.
    K = torch.as_tensor(np.stack([
        np.array([[2.0, 0.3], [0.3, 1.0]]),
        np.array([[1.0, 0.3], [0.3, 0.09 - 1e-10]]),
    ]))
    first = TL.Jitter("first_rung")
    L = first.cholesky(K)
    assert int(first.count) == 1 and torch.isnan(L[1]).all()
    assert torch.equal(L[0], TL.Jitter("device").cholesky(K[0]))


class _Spy(TF.Eager):
    """An eager runner that logs, at each ``layer_init`` and
    ``layer_finish``, the layer and the ladder's escalation count."""

    def __init__(self, step):
        super().__init__(step)
        self.log = []

    def __call__(self, name):
        if name in ("layer_init", "layer_finish"):
            self.log.append((name, int(self.step.layer), int(self.step.finish.count)))
        return super().__call__(name)


@contextlib.contextmanager
def _jitter(eps):
    old = gpar_torch.config.epsilon
    gpar_torch.config.epsilon = eps
    try:
        yield
    finally:
        gpar_torch.config.epsilon = old


def _fit(rule, dense, restarts, eps, w, monkeypatch=None):
    """The scan fit through ``Eager``: ``(results, stats, log, repaired)``."""
    _, step = scan_step("cpu", dense=dense, restarts=restarts, rule=rule, w=w)
    repaired = []
    if monkeypatch is not None:
        real = TF.ScanStep.on_the_ladder

        def spy(self):
            repaired.append(int(self.layer))
            return real(self)

        monkeypatch.setattr(TF.ScanStep, "on_the_ladder", spy)
    run, stats = _Spy(step), new_stats()
    with _jitter(eps):
        out = TF.run_scan_fit(step, run, ITERS, stats)
    return out, stats, run.log, repaired


@pytest.mark.parametrize("dense, restarts, eps, heavy", [
    (True, 1, -1e-4, 1),
    (True, 3, -1e-4, 1),
    (False, 1, -1e-2, None),
    (False, 2, -1e-1, None),
], ids=["dense", "dense-restarts", "sparse", "sparse-restarts"])
def test_a_failed_first_rung_gives_the_ladders_fit(monkeypatch, dense, restarts, eps, heavy):
    # A negative first jitter (and, dense, output 1's noise weighted down to
    # nothing) makes some first-rung factorisations fail.  The layers whose
    # ladder escalated in their iterations are exactly those run again, and
    # the fit is the ladder's bit for bit: latents, layer_nll, layer_iters,
    # layer_nll0 and the escalation count.
    w = None
    if heavy is not None:
        w = np.ones((100, 3))
        w[:, heavy] = 1e30
    got, stats, _, repaired = _fit("first_rung", dense, restarts, eps, w, monkeypatch)
    want, ladder_stats, log, _ = _fit("device", dense, restarts, eps, w)
    escalated = [pi for (_, pi, a), (_, _, b) in zip(log[::2], log[1::2]) if b > a]
    assert repaired == escalated and escalated
    assert stats["ladder_repairs"] == len(escalated) and ladder_stats["ladder_repairs"] == 0
    assert stats["ladder_escalations"] == ladder_stats["ladder_escalations"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_one_factorisation_per_factor_per_evaluation(monkeypatch, dense):
    # Two factors an evaluation (Kmm and LB) sparse, one dense: layer_init,
    # step and trial each factor that many matrices, once each; the ladder
    # (layer_finish) probes four rungs and factors once more.
    _, step = scan_step("cpu", dense=dense, rule="first_rung")
    calls = []
    real = torch.linalg.cholesky_ex

    def counting(A, *args, **kwargs):
        calls.append(A.shape)
        return real(A, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", counting)
    run, factors = TF.Eager(step), 1 if dense else 2
    counts = {}
    for name in ("layer_init", "step", "trial", "layer_finish"):
        calls.clear()
        run(name)
        counts[name] = len(calls)
    assert counts == {"layer_init": factors, "step": factors, "trial": factors,
                      "layer_finish": 5 * factors}


@pytest.mark.parametrize("restarts", [1, 3])
def test_bodies_before_a_repair_move_nothing_layer_init_keeps(restarts):
    # layer_init, step, trial and commit write only the layer's slice, the
    # optimiser's buffers and the failure count (the status); after any of
    # them, layer_init and a step give the buffers of a step that never ran
    # them.
    _, step = scan_step("cpu", dense=True, restarts=restarts, rule="first_rung")
    fresh = step.clone()
    run = TF.Eager(step)
    run("layer_init")
    assert step.opt.status is step.evals.count
    allowed = {id(b) for b in [*step.lin.values(), *step.opt.buffers(), step.evals.count]}
    before = [b.clone() for b in step._buffers()]
    for name in ("step", "commit", "step", "trial", "trial", "commit", "step"):
        run(name)
    moved = {id(b) for b, a in zip(step._buffers(), before) if not torch.equal(a, b)}
    assert moved and moved <= allowed
    for r in (run, TF.Eager(fresh)):
        r("layer_init")
        r("step")
    for a, b in zip(step._buffers(), fresh._buffers()):
        assert torch.equal(a, b)


def test_first_rung_bodies_read_nothing_back_to_the_host():
    # As tests/test_torch_fused.py's meta-device test, with the first rung.
    _, cpu = scan_step("cpu", rule="first_rung")
    for restarts in (1, 3):
        step = TF.ScanStep(cpu.plan, cpu.n_rows, cpu.n_ind, torch.float64, "meta",
                           restarts=restarts, rule="first_rung")
        assert tuple(step.opt.flags.shape) == ((3,) if restarts == 1 else (restarts, 3))
        run = TF.Eager(step)
        for name in step.BODIES:
            run(name)


def test_routes_without_a_read_each_evaluation_keep_the_ladder():
    # new_step takes the first rung only where iters > 0 (a flags read
    # follows every evaluation); the mesh step keeps the ladder.
    from gpar_torch.parallel import make_mesh

    _, cpu = scan_step("cpu")
    args = (cpu.plan, cpu.n_rows, cpu.n_ind, torch.float64, "cpu", 1e-9, 10)
    graphed = TF.new_step(*args, iters=3)
    assert graphed.evals.rule == "first_rung" and graphed.finish.rule == "device"
    assert graphed.opt.status is graphed.evals.count
    for step in (TF.new_step(*args, iters=0),
                 TF.new_step(*args, mesh=make_mesh(2, devices=[torch.device("cpu")] * 2), iters=3)):
        assert step.evals is step.finish and step.finish.rule == "device"
        assert step.opt.status is None and tuple(step.opt.flags.shape) == (2,)
