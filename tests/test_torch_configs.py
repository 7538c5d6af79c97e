"""The examples' model configurations through gpar_torch against gpar_tpu,
float64, on the CPU: one parametrised test, one case per configuration.

Each case is an example's constructor (``examples/exchange.py``,
``jura.py``, ``ml.py``, ``eeg.py``) or a combination of the options no
example sets (``per`` with its period, scale and decay, ``input_linear``,
``markov``, ``scale_tie``), on 40 rows of a 3-output chain with missing
outputs, at the example's input width (m = 2 for jura, 6 for ml), sparse or
dense, ``compat`` True or False, the ``transform_y`` of ``log_transform``
and ``squishing_transform``, ``impute=False`` and non-unit training
weights.  Per case:

- ``fit`` (the scan route, ``fix=True``, 3 iterations): layer NLLs and
  latents to 1e-8;
- ``predict`` at JAX's fitted latents, carried across, from JAX's
  standard normals (mean and credible bounds), and ``logpdf`` of other data
  (prior and posterior, non-unit weights): 1e-8;
- every layer's kernel tree, as the estimator builds it and as the scan
  step gates it, is taken by the Gram kernel's analyser wherever the JAX
  analyser takes the estimator's tree (none is refused: no tree of these
  configurations goes to ``gram_eval``).
"""

import numpy as np
import pytest

from .test_torch_common import close, jax, jax_chain_normals, torch

import gpar_tpu.models.regressor as JR  # noqa: E402
import gpar_tpu.ops.pallas_gram as JG  # noqa: E402

import gpar_torch.models.fused as TF  # noqa: E402
import gpar_torch.models.regressor as TR  # noqa: E402
import gpar_torch.ops.gram_kernel as TG  # noqa: E402

N, P, NT, S, ITERS = 40, 3, 8, 6, 3
TOL = 1e-8

#: name -> (constructor arguments, input width, inducing points, transform,
#: non-unit weights)
CONFIGS = {
    # examples/exchange.py: rq, replace=False; weights.
    "exchange": (dict(scale=0.1, linear=True, linear_scale=10.0, nonlinear=True,
                      nonlinear_scale=1.0, rq=True, noise=0.01, impute=True, replace=False,
                      normalise_y=True, compat=True), 1, 0, None, True),
    # examples/jura.py: m = 2, linear=False, log_transform; impute=False.
    "jura": (dict(scale=10.0, linear=False, nonlinear=True, nonlinear_scale=1.0, noise=0.1,
                  impute=False, replace=True, normalise_y=True, compat=False), 2, 0, "log", False),
    # examples/ml.py: m = 6, sparse; Markov order 1 and one tied scale.
    "ml": (dict(scale=1.0, linear=True, linear_scale=100.0, nonlinear=True, nonlinear_scale=1.0,
                noise=0.01, impute=True, replace=True, normalise_y=True, markov=1, scale_tie=True,
                compat=True), 6, 8, None, False),
    # examples/eeg.py: linear=False at scale 0.02; squishing_transform.
    "eeg": (dict(scale=0.02, linear=False, nonlinear=True, nonlinear_scale=1.0, noise=0.01,
                 impute=True, replace=False, normalise_y=True, compat=False), 1, 0, "squish", False),
    # The locally periodic and the input dot-product terms, sparse; weights.
    "periodic": (dict(per=True, per_period=3.0, per_scale=1.0, per_decay=10.0, input_linear=True,
                      input_linear_scale=10.0, linear=True, linear_scale=10.0, noise=0.1,
                      replace=True, normalise_y=False, compat=False), 1, 6, None, True),
}


def _data(m, transform, seed=3):
    r = np.random.default_rng(seed)
    x = r.uniform(0.0, 10.0, (N, m))
    x_test = r.uniform(0.5, 9.5, (NT, m))
    t = x[:, 0] + 0.3 * x.sum(axis=1)
    cols = [np.sin(t)]
    for i in range(1, P):
        cols.append(np.cos(cols[-1]) ** 2 + np.sin((i + 1) * t / 3.0))
    y = np.stack(cols, axis=1) + 0.05 * r.standard_normal((N, P))
    if transform == "log":
        y = np.exp(y)  # positive, as jura's concentrations
    y[r.uniform(size=(N, P)) < 0.1] = np.nan
    y[:, 0][np.isnan(y[:, 0])] = 1.0  # the first output observed everywhere
    w = r.uniform(0.5, 2.0, (N, P))
    return x, y, w, x_test


def _kwargs(case, pkg):
    kw, m, n_ind, transform, _ = CONFIGS[case]
    kw = dict(kw)
    if n_ind:
        kw["x_ind"] = np.random.default_rng(11).uniform(0.0, 10.0, (n_ind, m))
    if transform:
        mod = JR if pkg == "jax" else TR
        kw["transform_y"] = mod.log_transform if transform == "log" else mod.squishing_transform
    return kw


def _trees(case, rj, rt):
    """Layer ``pi``'s tree at the fitted latents, as each package's
    estimator builds it, and the port's gated scan tree."""
    cfg_j, cfg_t = rj.model_config, rt.model_config
    names = rt.vs.select(None)
    plan = rt._scan_fit_plan(names)
    xs = TF.plan_tensors(plan, rt.dtype, rt.device)
    z = rt.vs.latent_vector(names)
    z_ext = torch.cat([z, z.new_zeros(1)])  # the dummy slot
    out = []
    for pi in range(P):
        fj, _ = JR._model_generator(rj.vs, rj.m, pi, **cfg_j)()
        ft, _ = TR._model_generator(rt.vs, rt.m, pi, **cfg_t)()
        gated, _ = TF._layer_kernel(plan, {k: v[pi] for k, v in xs.items()}, z_ext)
        out.append((fj.kernel, ft.kernel, gated))
    return out, plan


@pytest.mark.parametrize("case", list(CONFIGS))
def test_config_matches_jax(case):
    _, m, _, transform, weighted = CONFIGS[case]
    x, y, w, x_test = _data(m, transform)
    w = w if weighted else None
    rj = JR.GPARRegressor(**_kwargs(case, "jax"))
    rj.fit(x, y, w, iters=ITERS)
    rt = TR.GPARRegressor(**_kwargs(case, "torch"), device="cpu")
    rt.fit(x, y, w, iters=ITERS)
    rep, jrep = rt.last_fit_report, rj.last_fit_report
    assert rep["fused"] and rep["layer_iters"].tolist() == np.asarray(jrep["layer_iters"]).tolist()
    close(rep["layer_nll"], jrep["layer_nll"], rtol=TOL)
    sj, st = rj.vs.snapshot(), rt.vs.snapshot()
    assert list(sj) == list(st)
    for k in sj:
        close(st[k], sj[k], rtol=TOL, atol=1e-10)

    # Prediction and scores at JAX's latents: the fitted latents agree to
    # rounding, which the locally periodic term's period amplifies.
    rt.load_latents(sj)
    key = jax.random.PRNGKey(4)
    want = rj.predict(x_test, num_samples=S, credible_bounds=True, key=key)
    z1, z2 = jax_chain_normals(key, P, NT, num_samples=S, noise=True)
    got = rt.predict(x_test, num_samples=S, credible_bounds=True, normals=z1, noise_normals=z2)
    for a, b in zip(got, want):
        assert a.shape == (NT, P)
        close(a, b, rtol=TOL, atol=1e-10)

    xs, ys, ws, _ = _data(m, transform, seed=8)
    for post in (False, True):
        close(rt.logpdf(xs, ys, ws, posterior=post), rj.logpdf(xs, ys, ws, posterior=post),
              rtol=TOL)

    trees, plan = _trees(case, rj, rt)
    for pi, (tj, tt, gated) in enumerate(trees):
        if JG.analyze_kernel(tj) is not None:
            assert TG.analyze_kernel(tt, m + pi) is not None, (case, pi, "estimator tree refused")
            assert TG.analyze_kernel(gated, plan.W) is not None, (case, pi, "scan tree refused")
