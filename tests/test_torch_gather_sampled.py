"""The two kernels of the unfused composition — ``gather_scale`` (H') and
``sampled_matmul`` (the even-tiled dW) — in their plain versions against
the JAX package: the jnp oracles (``repro.kernels.ref``) and the Pallas
kernels run through the interpreter, on the same numpy inputs, over the
reference sweeps.  Also the H' the sampled linear now builds through
``gather_scale``, the wrappers' host padding and their refusals.  The CUDA
kernels themselves are held against the same plain versions on the card
by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plans as jax_plans
from repro.core.kernel_config import KernelConfig as JaxKernelConfig
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import WTACRSConfig, linear
from repro_torch.kernels import _build, fused_sampling, gather_scale, ops
from repro_torch.kernels import sampled_matmul as smm

torch.set_num_threads(1)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
              "float16": jnp.float16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def icfg(**blocks):
    """Interpret-mode Pallas config with pinned blocks (no table)."""
    return JaxKernelConfig(backend="pallas", autotune=False, **blocks)


def both(x: np.ndarray, dtype: str):
    """One f32 numpy array as a jax and a torch array of ``dtype`` (both
    round to nearest even, so the values are bit-identical)."""
    return (jnp.asarray(x, JAX_DTYPES[dtype]),
            torch.from_numpy(x).to(TORCH_DTYPES[dtype]))


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a.astype(jnp.float32))


def assert_bits_equal(got, want):
    np.testing.assert_array_equal(as_np(got).view(np.uint32),
                                  as_np(want).view(np.uint32))


# ---------------------------------------------------------------------------
# gather_scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k", [(64, 96, 16), (50, 130, 20), (16, 8, 16),
                                   (128, 256, 40)])
def test_gather_scale_matches_reference_bit_for_bit(n, d, k, dtype):
    rng = np.random.RandomState(n * 100 + k)
    xj, xt = both(rng.randn(n, d).astype(np.float32), dtype)
    idx = rng.randint(0, n, (k,)).astype(np.int32)
    scale = rng.rand(k).astype(np.float32)
    got = ops.gather_scale(xt, torch.from_numpy(idx), torch.from_numpy(scale))
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (k, d)
    # one f32 multiply and one rounding per element on every side: equal
    # to the bit (the reference sweep holds 1e-5 / 2e-2, this is stricter)
    assert_bits_equal(got, jax_ref.gather_scale_ref(xj, jnp.asarray(idx),
                                                    jnp.asarray(scale)))
    pallas = jax_ops.gather_scale(xj, jnp.asarray(idx), jnp.asarray(scale),
                                  kernel=icfg(block_d=64))
    assert_bits_equal(got, pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("b,n,d,k", [(3, 7, 5, 4), (2, 50, 130, 20),
                                     (4, 16, 8, 16)])
def test_gather_scale_batched_with_repeated_rows(b, n, d, k, dtype):
    """The batched form is B independent 2-D gathers; plans sample with
    replacement, so rows repeat (slot 1 names slot 0's row here)."""
    rng = np.random.RandomState(b * 1000 + n)
    xj, xt = both(rng.randn(b, n, d).astype(np.float32), dtype)
    idx = rng.randint(0, n, (b, k)).astype(np.int32)
    idx[:, 1] = idx[:, 0]
    scale = (rng.rand(b, k) * 2).astype(np.float32)
    scale[:, 1] = scale[:, 0]
    got = ops.gather_scale(xt, torch.from_numpy(idx), torch.from_numpy(scale))
    assert got.shape == (b, k, d)
    want = jnp.stack([jax_ref.gather_scale_ref(xj[i], jnp.asarray(idx[i]),
                                               jnp.asarray(scale[i]))
                      for i in range(b)])
    assert_bits_equal(got, want)
    assert torch.equal(got[:, 0], got[:, 1])
    for i in range(b):
        assert torch.equal(got[i], ops.gather_scale(
            xt[i], torch.from_numpy(idx[i]), torch.from_numpy(scale[i])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rowgather_of_the_sampled_linear_is_the_plain_row_gather(dtype):
    """H' is now built by gather_scale at unit scale: bit for bit the
    ``torch.gather`` the train path used before."""
    rng = np.random.RandomState(5)
    _, x = both(rng.randn(3, 40, 24).astype(np.float32), dtype)
    idx = torch.from_numpy(rng.randint(0, 40, (3, 12)).astype(np.int32))
    rows = idx.to(torch.int64)[:, :, None].expand(3, 12, 24)
    assert torch.equal(linear._rowgather(x, idx), torch.gather(x, 1, rows))


def _gs_args():
    return [torch.zeros(2, 6, 8), torch.zeros(2, 4, dtype=torch.int32),
            torch.ones(2, 4)]


@pytest.mark.parametrize("which,change,error", [
    (0, lambda t: t.to(torch.float64), TypeError),           # x dtype
    (1, lambda t: t.to(torch.int64), TypeError),             # idx dtype
    (2, lambda t: t.to(torch.float64), TypeError),           # scale dtype
    (0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),                                            # strides
    (1, lambda t: t[:, :3], ValueError),                     # plan shape
    (2, lambda t: t[0], ValueError),                         # scale rank
    (1, lambda t: t[0], ValueError),                         # idx rank
    (0, lambda t: t[:, :0], ValueError),                     # empty
    (1, lambda t: t.to("meta"), ValueError),                 # device
])
def test_gather_scale_wrapper_refuses_what_the_kernel_does_not_take(
        which, change, error):
    args = _gs_args()
    args[which] = change(args[which])
    with pytest.raises(error):
        ops.gather_scale(*args)


# ---------------------------------------------------------------------------
# sampled_matmul
# ---------------------------------------------------------------------------

SWEEP_2D = [(16, 32, 24, 64), (20, 130, 70, 50), (8, 16, 16, 16),
            (64, 128, 96, 200)]
SWEEP_BATCHED = [(1, 16, 32, 24, 64), (2, 20, 130, 70, 50),
                 (8, 12, 33, 17, 30)]


def _smm_inputs(shape_b, k, di, do, n, dtype, seed):
    rng = np.random.RandomState(seed)
    lead = () if shape_b is None else (shape_b,)
    hj, ht = both(rng.randn(*lead, k, di).astype(np.float32), dtype)
    zj, zt = both(rng.randn(*lead, n, do).astype(np.float32), dtype)
    idx = rng.randint(0, n, lead + (k,)).astype(np.int32)
    scale = rng.rand(*lead, k).astype(np.float32)
    return (hj, zj, jnp.asarray(idx), jnp.asarray(scale)), \
        (ht, zt, torch.from_numpy(idx), torch.from_numpy(scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,di,do,n", SWEEP_2D)
def test_sampled_matmul_matches_oracle(k, di, do, n, dtype):
    jx, tx = _smm_inputs(None, k, di, do, n, dtype, k * 31 + di)
    got = ops.sampled_matmul(*tx)
    assert got.dtype == torch.float32 and got.shape == (di, do)
    # the oracle keeps dz*scale in f32, the kernel rounds it once to the
    # input dtype: the reference sweep's own tolerances
    tol = dict(rtol=3e-2, atol=3e-1) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(as_np(got),
                               as_np(jax_ref.sampled_matmul_ref(*jx)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,di,do,n", SWEEP_2D)
def test_sampled_matmul_matches_interpreted_pallas(k, di, do, n, dtype):
    jx, tx = _smm_inputs(None, k, di, do, n, dtype, k * 37 + do)
    got = ops.sampled_matmul(*tx)
    pallas = jax_ops.sampled_matmul(*jx, kernel=icfg(bm=16, bn=16, bk=8))
    # both round dz*scale once to the input dtype and accumulate in f32,
    # each over its own padding: the products agree exactly, only the f32
    # summation order differs
    np.testing.assert_allclose(as_np(got), as_np(pallas), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,di,do,n", SWEEP_BATCHED)
def test_sampled_matmul_batched(b, k, di, do, n, dtype):
    jx, tx = _smm_inputs(b, k, di, do, n, dtype, b * 7919 + k)
    got = ops.sampled_matmul(*tx)
    want = jax_ref.sampled_matmul_batched_ref(*jx)
    tol = dict(rtol=3e-2, atol=3e-1 * b) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4 * b)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)
    pallas = jax_ops.sampled_matmul(*jx, kernel=icfg(bm=16, bn=16, bk=8))
    # same factors, f32 sums in another order
    np.testing.assert_allclose(as_np(got), as_np(pallas), rtol=1e-4,
                               atol=1e-4 * b)
    # and the fused kernel's plain version: the same function
    np.testing.assert_allclose(as_np(got),
                               as_np(ops.fused_sampled_dw(*tx)),
                               rtol=1e-5, atol=1e-5 * b)


def test_sampled_matmul_matches_linear_backward():
    """The kernels compute exactly the dW the sampled linear's backward
    produces, on a plan built by the reference."""
    rng = np.random.RandomState(3)
    h = rng.randn(1, 64, 32).astype(np.float32)
    dz = rng.randn(64, 16).astype(np.float32)
    p = jax.random.dirichlet(jax.random.PRNGKey(0), jnp.ones(64))
    plan = jax_plans.wtacrs_plan(p, 20, jax.random.PRNGKey(1))
    idx, scale = np.array(plan.idx), np.array(plan.scale)
    want = h[0][idx].T @ (dz[idx] * scale[:, None])
    h_sub = torch.from_numpy(h[0][idx])
    args = (h_sub, torch.from_numpy(dz), torch.from_numpy(idx),
            torch.from_numpy(scale))
    for fn in (ops.sampled_matmul, ops.fused_sampled_dw):
        got = fn(*args) if fn is ops.sampled_matmul else fn(
            *(a[None] for a in args))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    w = torch.from_numpy(rng.randn(32, 16).astype(np.float32) * 0.1)
    w.requires_grad_(True)
    z = linear.wtacrs_linear(
        torch.from_numpy(h), w,
        cfg=WTACRSConfig(kind="wta_crs", budget=20 / 64, min_rows=4),
        plan=(torch.from_numpy(idx)[None], torch.from_numpy(scale)[None]))
    (z * torch.from_numpy(dz)[None]).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,di,do,n", SWEEP_BATCHED)
def test_unfused_composition_matches_fused(b, k, di, do, n, dtype):
    """The reference's acceptance composition, per sample: row norms feed
    the plan (built by the reference and injected), gather_scale builds
    H', sampled_matmul takes the product; it equals fused_sampled_dw on
    the same plan within f32-accumulation tolerance, and the reference's
    own (interpreted) composition."""
    rng = np.random.RandomState(b * 13 + di)
    hj, ht = both(rng.randn(b, n, di).astype(np.float32), dtype)
    zj, zt = both(rng.randn(b, n, do).astype(np.float32), dtype)
    cfg = icfg(bm=16, bn=16, bk=8, block_rows=16, block_d=32)
    norms_t = ops.row_norms(ht.reshape(-1, di)).reshape(b, n)
    idxs, scales = [], []
    for i in range(b):
        norms = jax_ops.row_norms(hj[i], kernel=cfg)
        # same f32 sums of squares, another order
        np.testing.assert_allclose(norms_t[i].numpy(), np.asarray(norms),
                                   rtol=1e-5, atol=1e-5)
        plan = jax_plans.wtacrs_plan(norms / jnp.sum(norms), k,
                                     jax.random.PRNGKey(i))
        idxs.append(np.array(plan.idx))
        scales.append(np.array(plan.scale))
    idx, scale = np.stack(idxs), np.stack(scales)
    it, st = torch.from_numpy(idx), torch.from_numpy(scale)
    hsub = ops.gather_scale(ht, it, torch.ones((b, k)))
    unfused = ops.sampled_matmul(hsub, zt, it, st)
    fused = ops.fused_sampled_dw(hsub, zt, it, st)
    jhsub = jnp.stack([jax_ops.gather_scale(hj[i], jnp.asarray(idx[i]),
                                            jnp.ones((k,), jnp.float32),
                                            kernel=cfg) for i in range(b)])
    assert_bits_equal(hsub, jhsub)
    jax_unfused = jax_ops.sampled_matmul(jhsub, zj, jnp.asarray(idx),
                                         jnp.asarray(scale), kernel=cfg)
    tol = dict(rtol=3e-2, atol=3e-1 * b) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4 * b)
    np.testing.assert_allclose(as_np(unfused), as_np(fused), **tol)
    np.testing.assert_allclose(as_np(unfused), as_np(jax_unfused), **tol)


@pytest.mark.parametrize("tile", [64, 128])
def test_sampled_matmul_pads_to_the_tiling_and_slices_back(tile):
    """The host padding: H' to (k', d_in'), dZ to d_out', idx/scale with
    idx 0 / scale 0 — the padded slots and columns contribute nothing.
    ``choose_tile`` picks 128 where every SM still gets a tile (one SM
    here) and 64 without a card, which is what the CPU wrapper pads to."""
    _, (h, z, idx, scale) = _smm_inputs(2, 20, 130, 70, 50, "bfloat16", 9)
    sms = {64: None, 128: 1}[tile]
    assert smm.choose_tile(torch.bfloat16, 130, 70, sms) == tile
    hp, zp, ip, sp = smm.pad_operands(h, z, idx, scale, tile,
                                      smm.BK[torch.bfloat16])
    assert hp.shape == (2, 32, -(-130 // tile) * tile)
    assert zp.shape == (2, 50, -(-70 // tile) * tile) and ip.shape == sp.shape == (2, 32)
    assert int(ip[:, 20:].abs().sum()) == 0 and float(sp[:, 20:].sum()) == 0
    got = smm.sampled_matmul_plain(hp, zp, ip, sp)[:130, :70]
    want = fused_sampling.fused_sampled_dw_plain(h, z, idx, scale)
    # the padding adds exact zeros to the same f32 sums
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ops.sampled_matmul(h, z, idx, scale).numpy(),
                               want.numpy(), rtol=1e-6, atol=1e-6)
    assert smm.choose_tile(torch.bfloat16, 2048, 11008, 132) == 128
    assert smm.choose_tile(torch.bfloat16, 2048, 256, 132) == 64
    assert smm.choose_tile(torch.float32, 2048, 11008, 132) == 64


@pytest.mark.parametrize("sms", [1, 132])   # 256 x 128 in clusters / 64 x 64
@pytest.mark.parametrize("b,k,n,di,do", [(2, 20, 50, 136, 72),
                                         (3, 70, 40, 264, 392),
                                         (1, 64, 64, 64, 64)])
def test_wgmma_route_hands_the_operands_over_unpadded(b, k, n, di, do, sms):
    """The wgmma route pads and copies nothing (TMA reads H' past k and d_in
    as zeros, the kernel fetches plan slots past k as idx 0, scale 0 and
    predicates the d_out edge): its operands give the same plain result as
    the reference's fully padded ones (``pad_operands`` to the kernel's
    tiles and 64-slot steps)."""
    _, (h, z, idx, scale) = _smm_inputs(b, k, di, do, n, "bfloat16", b + di)
    r = smm.smm_route(di, do, torch.bfloat16, True, sms)
    assert r.route == "wgmma"
    assert r.cluster == (2 if r.tile_m == 256 else 1)
    planned = smm.plan_operands(h, z, idx, scale, r)
    assert all(p is t for p, t in zip(planned, (h, z, idx, scale)))
    padded = smm.pad_operands(h, z, idx, scale, r.tile_m, 64)
    assert padded[0].shape[1] % 64 == 0 and padded[2].shape[1] % 64 == 0
    got = smm.sampled_matmul_plain(*planned)
    want = smm.sampled_matmul_plain(*padded)[:di, :do]
    # the padding adds exact zeros to the same f32 sums
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ops.sampled_matmul(h, z, idx, scale).numpy(),
                               want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_a_misaligned_view_takes_the_wmma_route_on_aligned_copies(dtype):
    """hsub and dz starting 2 bytes off a 16-byte boundary: the wmma route,
    whose even-tiled kernel loads 16-byte chunks, is handed padded or
    copied operands that all start on a boundary; the result is unchanged."""
    _, (h, z, idx, scale) = _smm_inputs(2, 64, 128, 192, 90, dtype, 5)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype)
        flat[1:] = x.flatten()
        return flat[1:].view(x.shape)
    hs, zs = shifted(h), shifted(z)
    r = smm.smm_route(128, 192, hs.dtype, _build.aligned16(hs, zs))
    assert r.route == "wmma"
    planned = smm.plan_operands(hs, zs, idx, scale, r)
    assert all(t.data_ptr() % 16 == 0 for t in planned)
    want = smm.sampled_matmul_plain(h, z, idx, scale)
    np.testing.assert_allclose(ops.sampled_matmul(hs, zs, idx, scale).numpy(),
                               want.numpy(), rtol=1e-6, atol=1e-6)


def _smm_args():
    return [torch.zeros(2, 4, 8), torch.zeros(2, 6, 8),
            torch.zeros(2, 4, dtype=torch.int32), torch.ones(2, 4)]


@pytest.mark.parametrize("which,change,error", [
    (1, lambda t: t.to(torch.bfloat16), TypeError),          # dz dtype
    (2, lambda t: t.to(torch.int64), TypeError),             # idx dtype
    (3, lambda t: t.to(torch.float64), TypeError),           # scale dtype
    (0, lambda t: t.to(torch.float64), TypeError),           # hsub dtype
    (0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),                                            # strides
    (2, lambda t: t[:, :3], ValueError),                     # plan shape
    (1, lambda t: t[0], ValueError),                         # rank
])
def test_sampled_matmul_wrapper_refuses_what_the_kernel_does_not_take(
        which, change, error):
    args = _smm_args()
    args[which] = change(args[which])
    with pytest.raises(error):
        ops.sampled_matmul(*args)


@pytest.mark.parametrize("bad", [-1, 6, 2**31 - 1])
@pytest.mark.parametrize("kernel", ["gather_scale", "sampled_matmul",
                                    "fused_sampled_dw"])
def test_an_index_outside_the_rows_raises_on_the_cpu(kernel, bad):
    """A plan index outside [0, n) is an error, not a row of zeros: the
    plain versions raise from torch.gather (the kernels assert on the card,
    which chip_smoke.py checks)."""
    hsub, dz, idx, scale = _smm_args()
    idx[1, 2] = bad
    with pytest.raises(RuntimeError, match="out of bounds"):
        if kernel == "gather_scale":
            ops.gather_scale(dz, idx, scale)
        else:
            getattr(ops, kernel)(hsub, dz, idx, scale)


def test_wrappers_count_no_launch_on_cpu():
    """The launch counters move only where a kernel is launched."""
    g0, s0 = ops.gather_scale.launches, ops.sampled_matmul.launches
    ops.gather_scale(*_gs_args())
    ops.sampled_matmul(*_smm_args())
    assert (ops.gather_scale.launches, ops.sampled_matmul.launches) == (g0, s0)
    assert gather_scale.gather_scale is ops.gather_scale
    assert smm.sampled_matmul is ops.sampled_matmul
