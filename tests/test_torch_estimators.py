"""``core/estimators.py`` and ``core/estimators_extra.py`` of the port
against the JAX package: the closed forms of the variance analysis on the
same numpy inputs (f32 on both sides), ``apply_plan`` on plans the
reference built, the keyless estimators end to end, and the
stratified-CRS plug-in through the registry (its draws are the port's
own, so it is held to its definition and statistically)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as jax_est
from repro.core import plans as jax_plans
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro_torch.core import (WTACRSConfig, apply_plan, approx_matmul,
                              crs_variance, empirical_estimator_stats,
                              exact_matmul, get_estimator, plans,
                              registered_estimators, theorem2_condition,
                              wtacrs_variance_bound)
from repro_torch.core.estimators_extra import stratified_crs_plan

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3, 4]


def _xy(seed, n=12, m=40, q=9, skew=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, m).astype(np.float32)
    y = rng.randn(m, q).astype(np.float32)
    if skew:
        # a few heavy column-row pairs, as the paper's leverage scores have
        x[:, :4] *= 6.0
    return x, y


def _p(x, y):
    w = np.linalg.norm(x, axis=0) * np.linalg.norm(y, axis=1)
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_forms_match_reference(seed):
    x, y = _xy(seed)
    p = _p(x, y)
    for k in (5, 12, 30):
        # f32 sums of the same terms in other orders: 1e-5 relative
        np.testing.assert_allclose(
            float(crs_variance(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(p), k)),
            float(jax_est.crs_variance(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(p), k)), rtol=1e-5)
        np.testing.assert_allclose(
            float(wtacrs_variance_bound(torch.from_numpy(x),
                                        torch.from_numpy(y),
                                        torch.from_numpy(p), k)),
            float(jax_est.wtacrs_variance_bound(
                jnp.asarray(x), jnp.asarray(y), jnp.asarray(p), k)),
            rtol=1e-5)
        holds, c, mass = theorem2_condition(torch.from_numpy(p), k)
        jh, jc, jm = jax_est.theorem2_condition(jnp.asarray(p), k)
        assert bool(holds) == bool(jh) and int(c) == int(jc)
        # the same prefix sum of the same sorted atoms (f32 eps)
        np.testing.assert_allclose(float(mass), float(jm), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["wta_crs", "crs", "det_topk"])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_apply_plan_on_reference_plans(kind, seed):
    """Given the reference's (idx, scale), the estimate is the same."""
    x, y = _xy(seed)
    p = jnp.asarray(_p(x, y))
    plan = jax_plans.build_plan(kind, p, 10, jax.random.PRNGKey(seed))
    want = jax_est.apply_plan(jnp.asarray(x), jnp.asarray(y), plan)
    tplan = plans.SamplePlan(torch.from_numpy(np.array(plan.idx)),
                             torch.from_numpy(np.array(plan.scale)),
                             torch.tensor(int(plan.c_size)),
                             torch.tensor(float(plan.det_mass)))
    got = apply_plan(torch.from_numpy(x), torch.from_numpy(y), tplan)
    # f32 product of the same k terms
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_keyless_estimators_match_reference_end_to_end(seed):
    """EXACT and DET_TOPK draw nothing: approx_matmul agrees outright."""
    x, y = _xy(seed)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for kind in ("exact", "det_topk"):
        cfg = dict(kind=kind, budget=0.25, min_rows=2)
        got = approx_matmul(xt, yt, WTACRSConfig(**cfg))
        want = jax_est.approx_matmul(jnp.asarray(x), jnp.asarray(y),
                                     JaxWTACRSConfig(**cfg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(exact_matmul(xt, yt).numpy(), x @ y,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["wta_crs", "crs", "stratified_crs"])
def test_unbiased_estimators_are_unbiased_and_wta_beats_crs(kind):
    """Monte-Carlo mean within 4 standard errors of X @ Y (the draws are
    the port's own, so the reference's numbers cannot be matched)."""
    x, y = _xy(7)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    gen = torch.Generator().manual_seed(0)
    n = 400
    cfg = WTACRSConfig(kind=kind, budget=0.25, min_rows=2)
    mean, var = empirical_estimator_stats(xt, yt, cfg, gen, n_trials=n)
    err = (mean - xt @ yt).abs()
    # per-entry standard error of the mean is at most sqrt(total var / n)
    assert float(err.max()) < 4 * float(torch.sqrt(var / n)) + 1e-4
    if kind == "wta_crs":
        _, var_crs = empirical_estimator_stats(
            xt, yt, WTACRSConfig(kind="crs", budget=0.25, min_rows=2),
            torch.Generator().manual_seed(0), n_trials=n)
        assert float(var) < float(var_crs)


@pytest.mark.parametrize("seed", SEEDS)
def test_crs_variance_predicts_the_empirical_variance(seed):
    x, y = _xy(seed, skew=False)
    p = torch.from_numpy(_p(x, y))
    k = 10
    _, var = empirical_estimator_stats(
        torch.from_numpy(x), torch.from_numpy(y),
        WTACRSConfig(kind="crs", budget=k / 40, min_rows=2),
        torch.Generator().manual_seed(seed), n_trials=600)
    closed = float(crs_variance(torch.from_numpy(x), torch.from_numpy(y),
                                p, k))
    # a variance estimate from 600 draws: within 25 %
    assert abs(float(var) - closed) < 0.25 * closed


def test_stratified_crs_is_registered_and_follows_its_definition():
    spec = get_estimator("stratified_crs")
    assert "stratified_crs" in registered_estimators()
    assert spec.needs_key and not spec.biased and spec.supports_shared
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(30)).astype(np.float32))
    k = 8
    pb = torch.stack([p, p.flip(0)])
    plan = stratified_crs_plan(pb, k, torch.Generator().manual_seed(1))
    assert plan.idx.shape == (2, k) and plan.idx.dtype == torch.int32
    for b in range(2):
        cdf = torch.cumsum(pb[b], 0)
        for t in range(k):
            i = int(plan.idx[b, t])
            # slot t's point lies in stratum [t/k, (t+1)/k) and inside the
            # CDF step of its atom
            lo = float(cdf[i - 1]) if i else 0.0
            assert lo <= (t + 1) / k + 1e-6 and float(cdf[i]) >= t / k - 1e-6
            np.testing.assert_allclose(float(plan.scale[b, t]),
                                       1.0 / (k * float(pb[b, i])),
                                       rtol=1e-6)
    one = stratified_crs_plan(p, k, torch.Generator().manual_seed(1))
    assert one.idx.shape == (k,)
    # a heavy atom with p >= m/k is hit at least m times
    heavy = torch.tensor([0.5, 0.1, 0.1, 0.1, 0.1, 0.1])
    idx = stratified_crs_plan(heavy, 4, torch.Generator().manual_seed(2)).idx
    assert int((idx == 0).sum()) >= 2
