"""The Gram backward of gpar_torch against gpar_tpu and against autograd.

``gram_terms_plain_vjp`` is the plain version of the hand-written backward
kernel (in ``gpar_torch/csrc/gram.cu``).  For every tree the fused tests
cover, the same seeded inputs and upstream gradient ``R`` go through it
(chained through the port's feature maps by autograd) and through
``jax.vjp`` of the JAX package's ``gram``; both are float64 and differ only
in summation order, so they agree to rtol 1e-10, atol 1e-12.
"""

import numpy as np
import pytest

from .test_torch_common import close, jax, jnp, torch
from .test_torch_kernels import FUSED, _build, _inputs

import gpar_tpu.ops.kernels as JK  # noqa: E402

import gpar_torch.ops.kernels as TK  # noqa: E402
from gpar_torch.ops import gram_kernel as GK  # noqa: E402


def _upstream(n, m, seed=9):
    return np.random.default_rng(seed).normal(size=(n, m))


@pytest.mark.parametrize("case", FUSED)
def test_plain_vjp_matches_jax_vjp(case):
    kj, kt, d = _build(case, np.float64)
    x, y = _inputs(d, np.float64)
    R = _upstream(x.shape[0], y.shape[0])

    xt = torch.as_tensor(x).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    tree, leaves = GK.map_leaves(kt, lambda l: l.detach().requires_grad_(True))
    kinds, dims, xf, yf, par = GK.prepare_terms(tree, xt, yt)
    cot = GK.gram_terms_plain_vjp(kinds, dims, xf.detach(), yf.detach(), par.detach(),
                                  torch.as_tensor(R))
    live = [(o, c) for o, c in zip((xf, yf, par), cot) if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in live], [xt, yt, *leaves], [c for _, c in live],
                              allow_unused=True)

    _, vjp = jax.vjp(lambda k, a, b: JK.gram(k, a, b), kj, jnp.asarray(x), jnp.asarray(y))
    gk, gx, gy = vjp(jnp.asarray(R))
    want = [gx, gy, *jax.tree_util.tree_leaves(gk)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = torch.zeros(tuple(np.shape(b)), dtype=torch.float64) if a is None else a
        close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", FUSED)
def test_plain_vjp_matches_autograd_of_plain(case):
    _, kt, d = _build(case, np.float64)
    x, y = _inputs(d, np.float64)
    R = torch.as_tensor(_upstream(x.shape[0], y.shape[0]))
    kinds, dims, xf, yf, par = GK.prepare_terms(kt, torch.as_tensor(x), torch.as_tensor(y))
    prep = [t.detach().requires_grad_(True) for t in (xf, yf, par)]
    want = torch.autograd.grad(GK.gram_terms_plain(kinds, dims, *prep), prep, R)
    got = GK.gram_terms_plain_vjp(kinds, dims, *[t.detach() for t in prep], R)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        close(a, b, rtol=1e-10, atol=1e-12)


def test_prepared_features_are_padded_to_four():
    _, kt, d = _build("bench-pi2", np.float64)  # widths 1 + 2 + 2
    x, y = _inputs(d, np.float64)
    kinds, dims, xf, yf, par = GK.prepare_terms(kt, torch.as_tensor(x), torch.as_tensor(y))
    assert sum(dims) == 5 and xf.shape[1] == yf.shape[1] == 8
    assert not torch.any(xf[:, 5:]) and not torch.any(yf[:, 5:])
    dxf, dyf, _ = GK.gram_terms_plain_vjp(kinds, dims, xf, yf, par,
                                          torch.ones(x.shape[0], y.shape[0], dtype=torch.float64))
    assert not torch.any(dxf[:, 5:]) and not torch.any(dyf[:, 5:])


def test_cpu_backward_launches_nothing_and_never_evaluates_the_tree(monkeypatch):
    _, kt, d = _build("layer-kernel-gated", np.float64)
    x, y = _inputs(d, np.float64)

    def refuse(*args):
        raise AssertionError("the fused Gram's backward re-evaluated the tree")

    xt = torch.as_tensor(x).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    tree, leaves = GK.map_leaves(kt, lambda l: l.detach().requires_grad_(True))
    GK.reset_counters()
    monkeypatch.setattr(TK, "_gram_eval", refuse)
    out = TK.gram(tree, xt, yt)
    grads = torch.autograd.grad(torch.sum(out * out), [xt, yt, *leaves])
    assert all(torch.isfinite(g).all() for g in grads)
    assert (GK.gram_kernel_launches, GK.gram_bwd_kernel_launches,
            GK.gram_plain_cuda_calls, GK.gram_eval_cuda_calls) == (0, 0, 0, 0)
    kinds, dims, xf, yf, par = GK.prepare_terms(kt, torch.as_tensor(x), torch.as_tensor(y))
    with pytest.raises(ValueError, match="CUDA"):
        GK.gram_bwd_kernel_launch(kinds, dims, xf, yf, par, out.detach())


# The scan path's Gram shapes (Kmn, Kmm, Kmt, the test covariance), the
# dense path's (K and the test cross-covariance, rows bucketed to 11 840) and
# a ragged one, with the gated tree's three terms, on an H100's 132 SMs, and
# the plan worked out by hand for each: (column tiles, row splits, rows per
# split, rows per step).  The big tile (64 rows a step in float32, 32 in
# float64) where one step per split of it gives at least 66 blocks (half the
# SMs), else the small one (16 rows); then the fewest splits with at least 3
# blocks per SM and the busiest SM within 1.2 times the mean, else one step
# per split.
_PLANS = {
    torch.float32: {
        # 93 x 3 x 4 = 1116 blocks at most: big; 1 split gives 2.11 per SM,
        # 2 give 4.23 (busiest 5 <= 5.07).
        (256, 11_840): (93, 2, 128, 64),
        # 2 x 3 x 4 = 24 < 66: small; 6 blocks a split never reach 3 per SM.
        (256, 256): (2, 16, 16, 16),
        # 10 x 3 x 4 = 120 >= 66: big; 4 splits give 0.91 per SM, so one
        # step per split.
        (256, 1216): (10, 4, 64, 64),
        # 10 x 3 x 19 = 570: big; 10 splits give 2.27 per SM, 19 give 4.32
        # (busiest 5 <= 5.18).
        (1216, 1216): (10, 19, 64, 64),
        # 93 x 3 x 185 = 51 615: big; 1 split gives 2.11 per SM, 2 splits of
        # 93 steps (5952 rows) give 4.23 (busiest 5 <= 5.07).
        (11_840, 11_840): (93, 2, 5952, 64),
        # 10 x 3 x 185 = 5550: big; 14 splits give 3.18 per SM but 4 on the
        # busiest (> 3.82), 15 splits of 13 steps give 3.41 (busiest 4 <= 4.09).
        (11_840, 1216): (10, 15, 832, 64),
        # 1 x 3 x 1 = 3 < 66: small, 3 steps of 16, never 3 per SM.
        (37, 23): (1, 3, 16, 16),
    },
    torch.float64: {
        # 185 x 3 = 555 blocks with no split: 4.20 per SM (busiest 5 <= 5.05).
        (256, 11_840): (185, 1, 256, 32),
        # 4 x 3 x 8 = 96 >= 66: big; 12 blocks a split never reach 3 per SM.
        (256, 256): (4, 8, 32, 32),
        # 19 x 3 x 8 = 456: big; 4 splits give 1.73 per SM, 8 give 3.45
        # (busiest 4 <= 4.15).
        (256, 1216): (19, 8, 32, 32),
        # 19 x 3 x 38 = 2166: big; 7 splits give 3.02 per SM but 4 on the
        # busiest (> 3.63), 8 splits of 5 steps give 3.45 (busiest 4 <= 4.15).
        (1216, 1216): (19, 8, 160, 32),
        # 185 x 3 = 555 blocks with no split, each walking all 370 steps:
        # 4.20 per SM (busiest 5 <= 5.05).
        (11_840, 11_840): (185, 1, 11_840, 32),
        # 19 x 3 = 57 blocks with no split; 7 splits give 3.02 per SM but 4
        # on the busiest (> 3.63), 8 splits of 47 steps (1504 rows) give 3.45
        # (busiest 4 <= 4.15).
        (11_840, 1216): (19, 8, 1504, 32),
        # 1 x 3 x 2 = 6 < 66: small, 3 steps of 16, never 3 per SM.
        (37, 23): (1, 3, 16, 16),
    },
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", list(_PLANS[torch.float32]))
def test_backward_plan_covers_rows_in_whole_steps_and_balances_the_sms(monkeypatch, n, m, dtype):
    monkeypatch.setattr(GK, "_sm_count", lambda device: 132)
    ct, r, rps, step = GK._bwd_plan(n, m, 3, dtype, "cuda")
    assert (ct, r, rps, step) == _PLANS[dtype][(n, m)]
    # One of the kernel's tiles, whole steps per split, and the sizes the
    # launch checks the partial buffers against (gram.cu, launch_bwd).
    assert step in GK._BWD_ROWS[dtype]
    assert rps >= step and rps % step == 0
    assert ct == -(-m // GK._BWD_COLS[dtype]) and r == -(-n // rps)
    # Every row in exactly one split, no split empty.
    rows = np.concatenate([np.arange(s * rps, min(n, (s + 1) * rps)) for s in range(r)])
    np.testing.assert_array_equal(rows, np.arange(n))
    assert (r - 1) * rps < n


# Plans over a batch of B elements (restarts, fused="batched"; the grid is
# B x terms x column tiles x row splits), worked by hand the same way on 132
# SMs with the gated tree's three terms: (B, n, m) -> plan.
_BATCHED_PLANS = {
    torch.float32: {
        # 4 x 3 x 93 = 1116 blocks with no split: 8.45 per SM (busiest 9 <=
        # 10.15); Kmn of 4 restarts needs no row split.
        (4, 256, 11_840): (93, 1, 256, 64),
        # 4 x 3 x 2 = 24 blocks a split, 192 at one step per split of the big
        # tile (>= 66): big; never 3 per SM, so one step per split.
        (4, 256, 256): (2, 4, 64, 64),
        # 64 x 3 x 19 = 3648: 27.64 per SM (busiest 28 <= 33.16).
        (64, 2432, 2432): (19, 1, 2432, 64),
        # 2 x 3 x 93 = 558: 4.23 per SM (busiest 5 <= 5.07); the dense step
        # with 2 restarts walks all its rows in one split.
        (2, 11_840, 11_840): (93, 1, 11_840, 64),
        # 4 x 3 x 1 x 1 = 12 blocks, 24 at one step per split of the big tile
        # (< 66): small, 3 steps of 16.
        (4, 37, 23): (1, 3, 16, 16),
    },
    torch.float64: {
        # 4 x 3 x 185 = 2220: 16.82 per SM (busiest 17 <= 20.18).
        (4, 256, 11_840): (185, 1, 256, 32),
        # 4 x 3 x 4 = 48 a split, 384 at one step per split (>= 66): big;
        # 2.91 per SM at 8 splits, one step each.
        (4, 256, 256): (4, 8, 32, 32),
        # 64 x 3 x 38 = 7296: 55.27 per SM (busiest 56 <= 66.33).
        (64, 2432, 2432): (38, 1, 2432, 32),
        # 2 x 3 x 185 = 1110: 8.41 per SM (busiest 9 <= 10.09).
        (2, 11_840, 11_840): (185, 1, 11_840, 32),
        # 12 blocks, 24 x 2 = 48 at one step per split of the big tile: small.
        (4, 37, 23): (1, 3, 16, 16),
    },
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m", list(_BATCHED_PLANS[torch.float32]))
def test_batched_backward_plan_counts_the_whole_grid(monkeypatch, B, n, m, dtype):
    monkeypatch.setattr(GK, "_sm_count", lambda device: 132)
    ct, r, rps, step = GK._bwd_plan(n, m, 3, dtype, "cuda", B)
    assert (ct, r, rps, step) == _BATCHED_PLANS[dtype][(B, n, m)]
    assert step in GK._BWD_ROWS[dtype] and rps % step == 0 and r == -(-n // rps)
    # The grid's z axis, B T, stays within the launch's limit.
    assert B * 3 <= 65_535
    # At one element the plan is the 2-D launch's.
    assert GK._bwd_plan(n, m, 3, dtype, "cuda", 1) == GK._bwd_plan(n, m, 3, dtype, "cuda")


@pytest.mark.parametrize("layout", ["both", "left shared", "right shared", "params shared"])
def test_batched_plain_vjp_is_the_per_element_vjp(layout):
    # The batched plain VJP (the backward kernel's plain version over a
    # batch) against each element's 2-D plain VJP: per element for an
    # operand with the batch axis, summed over the batch for a shared one.
    _, kt, d = _build("layer-kernel-gated", np.float64)
    x, y = _inputs(d, np.float64)
    kinds, dims, xf, yf, par = GK.prepare_terms(kt, torch.as_tensor(x), torch.as_tensor(y))
    r = np.random.default_rng(3)
    B = 3
    xb = xf[None] * torch.as_tensor(r.uniform(0.5, 1.5, (B, 1, xf.shape[1])))
    yb = yf[None] * torch.as_tensor(r.uniform(0.5, 1.5, (B, 1, yf.shape[1])))
    pb = par[None] * torch.as_tensor(r.uniform(0.5, 1.5, (B, par.shape[0])))
    ops = {"both": (xb, yb, pb), "left shared": (xf, yb, pb), "right shared": (xb, yf, pb),
           "params shared": (xb, yb, par)}[layout]
    g = torch.as_tensor(r.normal(size=(B, xf.shape[0], yf.shape[0])))
    got = GK.gram_terms_plain_vjp(kinds, dims, *ops, g)
    per = [GK.gram_terms_plain_vjp(kinds, dims, *[a[b] if a.ndim == k else a
                                                  for a, k in zip(ops, (3, 3, 2))], g[b])
           for b in range(B)]
    for i, (a, k) in enumerate(zip(ops, (3, 3, 2))):
        want = torch.stack([q[i] for q in per])
        want = want if a.ndim == k else want.sum(0)
        assert got[i].shape == a.shape
        close(got[i], want, rtol=1e-14, atol=1e-14)
    # The batched forward, element by element, likewise.
    K = GK.gram_terms_plain(kinds, dims, *ops)
    for b in range(B):
        el = [a[b] if a.ndim == k else a for a, k in zip(ops, (3, 3, 2))]
        close(K[b], GK.gram_terms_plain(kinds, dims, *el), rtol=1e-14, atol=1e-14)
