"""gpar_torch kernel algebra and the fused Gram module against gpar_tpu.

Every kernel tree is built twice from the same NumPy parameters — once
with ``gpar_tpu.ops.kernels`` and once with ``gpar_torch.ops.kernels`` — and
evaluated on the same inputs.  Tolerances: float64 evaluations agree to
1e-12 relative (the two packages differ only in summation order and, for
the fused path, in direct vs. norm-identity squared distances, both
rounding-level in float64); float32 against the Pallas kernel in interpret
mode to 1e-5 (float32 rounding of O(1) Gram entries); float64 gradients to
1e-10.
"""

import numpy as np
import pytest

from .test_torch_common import bench_kwargs, close, jax, jnp, np_, torch

import gpar_tpu.ops.kernels as JK  # noqa: E402
from gpar_tpu.models.regressor import GPARRegressor as JReg  # noqa: E402
from gpar_tpu.models.regressor import _model_generator as j_generator  # noqa: E402
from gpar_tpu.ops.pallas_gram import analyze_kernel as j_analyze  # noqa: E402
from gpar_tpu.ops.pallas_gram import gram_fused as j_gram_fused  # noqa: E402
from gpar_tpu.params.store import Vars as JVars  # noqa: E402

import gpar_torch.ops.kernels as TK  # noqa: E402
from gpar_torch.ops import gram_kernel as GK  # noqa: E402

from .torch_cases import CASES, FUSED, TorchFW, _inputs  # noqa: E402, F401


class _JaxFW:
    """The JAX package's constructors for the tree cases of
    ``torch_cases.py`` (``TorchFW`` is the port's)."""

    name = "jax"

    def __init__(self, dtype):
        self.dtype = dtype
        self.K = JK
        self.P = lambda a: jnp.asarray(np.asarray(a, dtype))

    def bench_tree(self, pi, m=1):
        """Layer ``pi``'s kernel exactly as the estimator builds it for the
        benchmark's configuration, at the hyperparameters of
        ``TorchFW.bench_tree``."""
        cfg = JReg(**bench_kwargs()).model_config
        vs = JVars(dtype=np.dtype(self.dtype).name)
        gen = j_generator(vs, m, pi, **cfg)
        gen()
        r = np.random.default_rng(100 + pi)
        snap0 = vs.snapshot()
        snap = {k: snap0[k] + 0.3 * r.standard_normal(np.shape(snap0[k])) for k in vs.names}
        vs.restore({k: np.asarray(v, self.dtype) for k, v in snap.items()})
        f, _ = gen()
        return f.kernel


def _build(case, dtype):
    build, d = CASES[case]
    return build(_JaxFW(dtype)), build(TorchFW(dtype)), d


@pytest.mark.parametrize("case", list(CASES))
def test_gram_eval_and_kdiag_match_jax(case):
    kj, kt, d = _build(case, np.float64)
    x, y = _inputs(d, np.float64)
    close(TK.gram_eval(kt, torch.as_tensor(x), torch.as_tensor(y)),
          JK.gram_eval(kj, jnp.asarray(x), jnp.asarray(y)), rtol=1e-12, atol=1e-13)
    close(TK.kdiag(kt, torch.as_tensor(x)), JK.kdiag(kj, jnp.asarray(x)),
          rtol=1e-12, atol=1e-13)


def test_sq_dists_matches_jax():
    x, y = _inputs(3, np.float64)
    close(TK.sq_dists(torch.as_tensor(x), torch.as_tensor(y)),
          JK.sq_dists(jnp.asarray(x), jnp.asarray(y)), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("case", list(CASES))
def test_gram_dispatch_matches_jax_f64(case):
    # The port's `gram` takes the fused path (the kernel's plain version on
    # a CPU tensor) for every tree its analyser accepts.
    kj, kt, d = _build(case, np.float64)
    x, y = _inputs(d, np.float64)
    close(TK.gram(kt, torch.as_tensor(x), torch.as_tensor(y)),
          JK.gram_eval(kj, jnp.asarray(x), jnp.asarray(y)), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("case", FUSED)
def test_plain_version_matches_pallas_interpret_f32(case):
    from jax.experimental.pallas import tpu as pltpu

    kj, kt, d = _build(case, np.float32)
    x, y = _inputs(d, np.float32)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    kinds, dims, xf, yf, par = GK.prepare_terms(kt, xt, yt)
    got = GK.gram_terms_plain(kinds, dims, xf, yf, par)
    with pltpu.force_tpu_interpret_mode():
        want = j_gram_fused(kj, jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (37, 23)
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", FUSED)
def test_gram_fn_gradients_match(case):
    kj, kt, d = _build(case, np.float64)
    x, y = _inputs(d, np.float64)
    R = np.random.default_rng(9).normal(size=(x.shape[0], y.shape[0]))

    def torch_grads(fn):
        xt = torch.as_tensor(x).requires_grad_(True)
        yt = torch.as_tensor(y).requires_grad_(True)
        tree, leaves = GK.map_leaves(kt, lambda l: l.detach().requires_grad_(True))
        loss = torch.sum(fn(tree, xt, yt) * torch.as_tensor(R))
        return torch.autograd.grad(loss, [xt, yt, *leaves])

    fused = torch_grads(GK.gram_fused_or_none)
    plain = torch_grads(TK.gram_eval)

    def jloss(k, a, b):
        return jnp.sum(JK.gram(k, a, b) * jnp.asarray(R))

    gk, gx, gy = jax.grad(jloss, argnums=(0, 1, 2))(kj, jnp.asarray(x), jnp.asarray(y))
    jgrads = [gx, gy, *jax.tree_util.tree_leaves(gk)]
    assert len(jgrads) == len(fused)
    for a, b, c in zip(fused, plain, jgrads):
        close(a, b, rtol=1e-10, atol=1e-12)
        close(a, c, rtol=1e-10, atol=1e-12)


def test_analyser_refuses_what_jax_refuses():
    for case in CASES:
        kj, kt, d = _build(case, np.float64)
        j_ok = j_analyze(kj) is not None
        t_ok = GK.analyze_kernel(kt, d) is not None
        if case in ("gate", "layer-kernel-gated"):
            # The one stated difference: the port folds Gate into the
            # feature map; the JAX analyser has no Gate branch.
            assert t_ok and not j_ok
        else:
            assert t_ok == j_ok, case
    assert not GK.supported(TK.RQ(torch.tensor(0.5)) * TK.RQ(torch.tensor(0.7)))
    # Term widths beyond 128 features are refused (the TPU kernel's lanes).
    assert GK.supported(TK.EQ(), d=128) and not GK.supported(TK.EQ(), d=129)


def test_analyser_terms_and_widths():
    _, kt, d = _build("bench-pi2", np.float64)
    terms, const = GK.analyze_kernel(kt, d)
    assert [t.kind for t in terms] == ["rbf", "lin", "rbf"]
    assert [t.dim for t in terms] == [1, 2, 2]
    assert const == 0.0
    _, kt, d = _build("periodic", np.float64)
    (term,), _ = GK.analyze_kernel(kt, d)
    assert term.kind == "rbf" and term.dim == 6


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    _, kt, d = _build("bench-pi2", np.float64)
    x, y = _inputs(d, np.float64)
    GK.reset_counters()
    TK.gram(kt, torch.as_tensor(x), torch.as_tensor(y))
    assert GK.gram_kernel_launches == 0 and GK.gram_plain_cuda_calls == 0
    kinds, dims, xf, yf, par = GK.prepare_terms(kt, torch.as_tensor(x), torch.as_tensor(y))
    with pytest.raises(ValueError, match="CUDA"):
        GK.gram_kernel_launch(kinds, dims, xf, yf, par)
