"""Plan building of the port against the JAX package.

Random draws do not cross frameworks, so parity is split: everything
deterministic about a plan (p, |C|, det_mass, the deterministic slots and
their scale 1, det_topk, the scale of a stochastic slot GIVEN the index
it drew) must agree exactly or to f32 eps on the same numpy inputs; the
stochastic part is held statistically (unbiasedness, variance <= CRS
under Theorem 2's condition), mirroring ``tests/test_estimators.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plans as jax_plans
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro_torch.core import plans
from repro_torch.core.config import NormSource, WTACRSConfig
from repro_torch.models import common as cm

torch.set_num_threads(1)


def gen(seed: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def dirichlet(seed, m, alpha=0.3, rows=None):
    rng = np.random.RandomState(seed)
    shape = (m,) if rows is None else (rows, m)
    p = rng.gamma(alpha, size=shape).astype(np.float64) + 1e-12
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def test_column_row_probabilities_match():
    rng = np.random.RandomState(0)
    x, y = np.abs(rng.randn(40)).astype(np.float32), \
        np.abs(rng.randn(40)).astype(np.float32)
    got = plans.column_row_probabilities(torch.from_numpy(x),
                                         torch.from_numpy(y))
    want = jax_plans.column_row_probabilities(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    zero = plans.column_row_probabilities(torch.zeros(8), torch.ones(8))
    np.testing.assert_array_equal(zero.numpy(), np.full(8, 0.125, np.float32))


@pytest.mark.parametrize("cap", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("k", [1, 4, 20, 63])
def test_optimal_c_size_matches(k, cap):
    p = -np.sort(-dirichlet(k, 64))
    csum = np.cumsum(p).astype(np.float32)
    got = plans.optimal_c_size(torch.from_numpy(csum), k, cap=cap)
    want = jax_plans.optimal_c_size(jnp.asarray(csum), k, cap=cap)
    assert int(got) == int(want)
    scores = [(1 - (float(csum[i - 1]) if i else 0.0)) / (k - i)
              for i in range(k)]
    if cap == 1.0:
        assert int(got) == int(np.argmin(scores))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [4, 12, 31])
def test_wtacrs_deterministic_part_matches(k, seed):
    """|C|, det_mass, the deterministic slots (and their scale 1) do not
    depend on the random stream: exact agreement.  (A distribution whose
    tail still holds mass an f32 can see: where 1 - sum_C p is below f32
    eps, |C| is decided by the rounding of the cumulative sum.)"""
    p = dirichlet(seed, 32, alpha=1.0)
    got = plans.wtacrs_plan(torch.from_numpy(p), k, gen(seed))
    want = jax_plans.wtacrs_plan(jnp.asarray(p), k, jax.random.PRNGKey(seed))
    c = int(want.c_size)
    assert int(got.c_size) == c
    assert got.idx.dtype == torch.int32 and got.scale.dtype == torch.float32
    np.testing.assert_allclose(float(got.det_mass), float(want.det_mass),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.idx[:c].numpy(),
                                  np.asarray(want.idx[:c]))
    np.testing.assert_array_equal(got.scale[:c].numpy(), np.ones(c))
    # the stochastic slots: drawn from the tail, scaled by Eq. 6 given
    # the index drawn
    order = np.argsort(-p, kind="stable")
    tail = set(order[c:].tolist())
    drawn = got.idx[c:].numpy()
    assert set(drawn.tolist()) <= tail
    # (1 - det_mass cancels in f32, so the residual is taken from the
    # port's own det_mass, which the line above holds to the reference's)
    resid = max(1.0 - float(got.det_mass), 0.0)
    np.testing.assert_allclose(got.scale[c:].numpy(),
                               resid / ((k - c) * p[drawn]), rtol=1e-5)


@pytest.mark.parametrize("k", [2, 10])
def test_det_topk_matches(k):
    p = dirichlet(3, 50)
    p[7] = p[21] = p[33]           # ties go to the lower index in both
    got = plans.det_topk_plan(torch.from_numpy(p), k)
    want = jax_plans.det_topk_plan(jnp.asarray(p), k)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.scale.numpy(), np.ones(k))
    assert int(got.c_size) == k
    np.testing.assert_allclose(float(got.det_mass), float(want.det_mass),
                               rtol=1e-6)


def test_batched_plan_equals_rowwise_plans():
    """The written-out batch dimension gives every row the plan it would
    get alone (deterministic part), as the reference's vmap does."""
    p = dirichlet(5, 48, rows=6)
    k = 14
    plan = plans.wtacrs_plan(torch.from_numpy(p), k, gen(0))
    assert plan.idx.shape == (6, k) and plan.c_size.shape == (6,)
    for b in range(6):
        want = jax_plans.wtacrs_plan(jnp.asarray(p[b]), k,
                                     jax.random.PRNGKey(b))
        c = int(want.c_size)
        assert int(plan.c_size[b]) == c
        np.testing.assert_array_equal(plan.idx[b, :c].numpy(),
                                      np.asarray(want.idx[:c]))
        assert (plan.scale[b, :c] == 1).all()
        assert (plan.scale[b, c:] != 1).any() or c == k


def test_crs_plan_scale_and_shapes():
    p = dirichlet(1, 50)
    plan = plans.crs_plan(torch.from_numpy(p), 10, gen(1))
    assert plan.idx.shape == (10,) and plan.scale.shape == (10,)
    assert int(plan.c_size) == 0 and float(plan.det_mass) == 0.0
    np.testing.assert_allclose(plan.scale.numpy(),
                               1.0 / (10 * p[plan.idx.numpy()]), rtol=1e-6)


def test_tail_draws_follow_the_tail_distribution():
    """The inverse-CDF draw is the categorical the reference draws from:
    frequencies over many draws match p restricted to the tail."""
    p = dirichlet(2, 16, alpha=1.0)
    k, rows = 8, 6000
    plan = plans.wtacrs_plan(torch.from_numpy(p).expand(rows, 16).contiguous(),
                             k, gen(0))
    c = int(plan.c_size[0])
    assert (plan.c_size == c).all()
    order = np.argsort(-p, kind="stable")
    tail = order[c:]
    draws = plan.idx[:, c:].numpy().ravel()
    freq = np.bincount(draws, minlength=16)[tail] / draws.size
    want = p[tail] / p[tail].sum()
    # binomial noise at ~48k draws is < 0.003 per cell
    np.testing.assert_allclose(freq, want, atol=0.01)


def _concentrated(seed, n=12, m=128, q=10, spike=8.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, m)
    y = rng.randn(m, q)
    x = x * (1.0 + spike * (rng.rand(1, m) > 0.85))
    return x.astype(np.float32), y.astype(np.float32)


def _estimates(x, y, kind, n_draws, seed):
    """(n_draws, n, q) estimates of x @ y from batched plans."""
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    p = plans.column_row_probabilities(torch.linalg.vector_norm(xt, dim=0),
                                       torch.linalg.vector_norm(yt, dim=1))
    cfg = WTACRSConfig(kind=kind, budget=0.3, min_rows=4)
    k = cfg.budget_rows(x.shape[1])
    plan = plans.build_batched_plans(p.expand(n_draws, -1).contiguous(), k,
                                     gen(seed), cfg)
    idx = plan.idx.long()
    xs = xt.t()[idx] * plan.scale[:, :, None]          # (draws, k, n)
    return torch.einsum("dkn,dkq->dnq", xs, yt[idx]), p, k


@pytest.mark.parametrize("kind", ["crs", "wta_crs"])
def test_monte_carlo_mean_converges(kind):
    x, y = _concentrated(0)
    exact = x @ y
    est, _, _ = _estimates(x, y, kind, 3000, 1)
    mean = est.mean(0).numpy()
    rel = np.linalg.norm(mean - exact) / np.linalg.norm(exact)
    assert rel < 0.05, f"{kind}: mean off by {rel}"


def test_wtacrs_variance_below_crs_when_theorem2_holds():
    x, y = _concentrated(4)
    exact = torch.from_numpy(x @ y)
    var = {}
    for kind in ("crs", "wta_crs"):
        est, p, k = _estimates(x, y, kind, 1500, 5)
        var[kind] = float(((est - exact) ** 2).sum((1, 2)).mean())
    # Theorem 2's condition: sum_C p_c > |C| / k
    ps = torch.sort(p, descending=True).values
    c = int(plans.optimal_c_size(torch.cumsum(ps, 0), k))
    assert c > 0 and float(ps[:c].sum()) > c / k
    assert var["wta_crs"] < var["crs"]


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("k", [1, 7, 31])
def test_plan_unbiasedness_identity_holds_exactly(k, seed):
    """E[estimate] == XY computed ANALYTICALLY over the sample space from
    the port's own |C| and scales: det part + sum over the tail of
    (p_j/resid) * scale_j * X_j Y_j, times (k - |C|) slots."""
    m = 32
    rng = np.random.RandomState(seed)
    p = dirichlet(seed + 100, m, alpha=1.0)
    x, y = rng.randn(3, m), rng.randn(m, 2)
    plan = plans.wtacrs_plan(torch.from_numpy(p), k, gen(seed))
    c = int(plan.c_size)
    order = np.argsort(-p, kind="stable")
    contrib = lambda i: np.outer(x[:, i], y[i, :])
    det = sum((contrib(i) for i in order[:c]), np.zeros((3, 2)))
    resid = 1.0 - float(plan.det_mass)
    stoc = np.zeros((3, 2))
    for j in order[c:]:
        scale_j = resid / ((k - c) * p[j])
        stoc += (k - c) * (p[j] / resid) * scale_j * contrib(j)
    np.testing.assert_allclose(det + stoc, x @ y, rtol=2e-4, atol=2e-4)
    # and the scales the plan reports are those scale_j
    drawn = plan.idx[c:].numpy()
    np.testing.assert_allclose(plan.scale[c:].numpy(),
                               resid / ((k - c) * p[drawn]), rtol=1e-4)


def test_plans_reproducible_per_seed_step_and_differ_across_tags():
    p = torch.from_numpy(dirichlet(9, 64, alpha=1.0, rows=4))
    ctx = cm.Ctx(policy=cm.Policy(), key=cm.fold_seed(1234, 17))

    def plan_for(context, tag):
        return plans.wtacrs_plan(p, 20, gen(context._key_for(tag)))

    a, b = plan_for(ctx, "b0/attn_o"), plan_for(ctx, "b0/attn_o")
    assert torch.equal(a.idx, b.idx) and torch.equal(a.scale, b.scale)
    other_tag = plan_for(ctx, "b0/mlp_wo")
    other_layer = plan_for(ctx.fold(1), "b0/attn_o")
    other_step = plan_for(cm.Ctx(policy=cm.Policy(),
                                 key=cm.fold_seed(1234, 18)), "b0/attn_o")
    for other in (other_tag, other_layer, other_step):
        assert not torch.equal(a.idx, other.idx)
        # the deterministic part is the same whatever the seed
        assert torch.equal(a.c_size, other.c_size)


def test_batched_row_weights_matches_reference():
    rng = np.random.RandomState(0)
    h = rng.randn(3, 16, 24).astype(np.float32)
    zn = np.abs(rng.randn(3, 16)).astype(np.float32)
    for source in ("activation_only", "cached_grad"):
        got = plans.batched_row_weights(
            torch.from_numpy(h), torch.from_numpy(zn),
            WTACRSConfig(norm_source=source))
        want = jax_plans.batched_row_weights(
            jnp.asarray(h), jnp.asarray(zn),
            JaxWTACRSConfig(norm_source=source))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert WTACRSConfig(norm_source="cached_grad").norm_source \
        is NormSource.CACHED_GRAD


def test_build_plan_dispatch_and_errors():
    p = torch.from_numpy(dirichlet(0, 16))
    plan = plans.build_plan("det_topk", p, 4, None)
    assert plan.idx.shape == (4,)
    with pytest.raises(ValueError, match="no sampling plan"):
        plans.build_plan("exact", p, 4, None)
    with pytest.raises(KeyError, match="unknown estimator"):
        plans.build_plan("nope", p, 4, None)
    with pytest.raises(ValueError, match="requires a generator"):
        plans.build_batched_plans(p[None], 4, None, WTACRSConfig())


def test_fully_concentrated_distribution_stays_finite():
    """All mass on fewer atoms than |C| can hold: the tail has zero mass;
    draws fall back to the eps-floored tail and scales stay finite."""
    p = torch.zeros(2, 16)
    p[:, 3] = 1.0
    plan = plans.wtacrs_plan(p, 6, gen(0))
    assert torch.isfinite(plan.scale).all()
    assert (plan.idx >= 0).all() and (plan.idx < 16).all()
    assert (plan.idx[:, 0] == 3).all()
