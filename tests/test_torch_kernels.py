"""The port's plain kernel versions against the JAX package: the jnp
oracles (``repro.kernels.ref``) and the Pallas kernels run through the
interpreter, on the same numpy inputs, over the reference sweep
(B x dtype x ragged).  On the CPU the port's wrappers take the plain
versions, which is what these tests run; the CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernel_config import KernelConfig as JaxKernelConfig
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import fused_sampling, ops, row_norms

torch.set_num_threads(1)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(64, 64), (100, 96), (33, 130),
                                 (256, 512), (8, 8)])
def test_row_norms_matches_reference(n, d, dtype):
    x = np.random.RandomState(n * 1000 + d).randn(n, d).astype(np.float32)
    xj, xt = both(x, dtype)
    got = ops.row_norms(xt)
    assert got.dtype == torch.float32 and got.shape == (n,)
    # same inputs, f32 accumulation on both sides; only the summation
    # order differs: 1e-5 (the reference sweep's own f32 tolerance)
    np.testing.assert_allclose(as_np(got), as_np(jax_ref.row_norms_ref(xj)),
                               rtol=1e-5, atol=1e-5)
    pallas = jax_ops.row_norms(xj, kernel=icfg(block_rows=32, block_d=64))
    np.testing.assert_allclose(as_np(got), as_np(pallas),
                               rtol=1e-5, atol=1e-5)


SWEEP = [
    (1, 16, 32, 24, 64),        # degenerate batch, aligned blocks
    (2, 20, 130, 70, 50),       # ragged last block in every dim
    (8, 12, 33, 17, 30),        # larger batch, ragged + tiny dims
    (2, 13, 32, 16, 40),        # k not a multiple of the k-block
]


def _dw_inputs(b, k, di, do, n, dtype):
    rng = np.random.RandomState(b * 7919 + k * 31 + di)
    hs = rng.randn(b, k, di).astype(np.float32)
    dz = rng.randn(b, n, do).astype(np.float32)
    idx = rng.randint(0, n, (b, k)).astype(np.int32)
    scale = rng.rand(b, k).astype(np.float32)
    hj, ht = both(hs, dtype)
    zj, zt = both(dz, dtype)
    return (hj, zj, jnp.asarray(idx), jnp.asarray(scale)), \
        (ht, zt, torch.from_numpy(idx), torch.from_numpy(scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,di,do,n", SWEEP)
def test_fused_sampled_dw_matches_oracle(b, k, di, do, n, dtype):
    jx, tx = _dw_inputs(b, k, di, do, n, dtype)
    got = ops.fused_sampled_dw(*tx)
    assert got.dtype == torch.float32 and got.shape == (di, do)
    want = jax_ref.sampled_matmul_batched_ref(*jx)
    # the oracle does not round dz*scale to bf16, the kernel (and the
    # port's plain version) does: the reference sweep's tolerance
    tol = dict(rtol=3e-2, atol=3e-1 * b) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4 * b)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,di,do,n", SWEEP)
def test_fused_sampled_dw_matches_interpreted_pallas(b, k, di, do, n, dtype):
    jx, tx = _dw_inputs(b, k, di, do, n, dtype)
    got = ops.fused_sampled_dw(*tx)
    bm, bn = (16, 16) if di % 16 == 0 and do % 16 == 0 else (di, do)
    pallas = jax_ops.fused_sampled_dw(*jx, kernel=icfg(bm=bm, bn=bn, bk=8))
    # both round dz*scale once to the input dtype and accumulate in f32:
    # the products agree exactly, only the f32 summation order differs
    np.testing.assert_allclose(as_np(got), as_np(pallas),
                               rtol=1e-4, atol=1e-4 * b)


def test_fused_batch_equals_sum_of_single_samples():
    _, (hs, dz, idx, scale) = _dw_inputs(4, 10, 24, 20, 32, "float32")
    whole = ops.fused_sampled_dw(hs, dz, idx, scale)
    parts = sum(ops.fused_sampled_dw(hs[i:i + 1], dz[i:i + 1],
                                     idx[i:i + 1], scale[i:i + 1])
                for i in range(4))
    # f32, same terms, batch order of the additions differs
    np.testing.assert_allclose(whole.numpy(), parts.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_fused_rounds_scaled_dz_once_to_input_dtype():
    """bf16: the scaled row is rounded to bf16 BEFORE the product (as the
    TPU kernel feeds its matrix unit), not kept in f32."""
    _, (hs, dz, idx, scale) = _dw_inputs(2, 8, 16, 16, 20, "bfloat16")
    got = fused_sampling.fused_sampled_dw_plain(hs, dz, idx, scale)
    rows = torch.stack([dz[b][idx[b].long()] for b in range(2)])
    rounded = (rows.float() * scale[:, :, None]).to(torch.bfloat16).float()
    want = torch.einsum("bki,bkj->ij", hs.float(), rounded)
    unrounded = torch.einsum("bki,bkj->ij", hs.float(),
                             rows.float() * scale[:, :, None])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert float((got - unrounded).abs().max()) > 1e-4


def test_wrappers_count_no_launch_on_cpu():
    """The launch counters move only where a kernel is launched."""
    r0, f0 = ops.row_norms.launches, ops.fused_sampled_dw.launches
    ops.row_norms(torch.ones(4, 4))
    _, tx = _dw_inputs(1, 4, 8, 8, 8, "float32")
    ops.fused_sampled_dw(*tx)
    assert (ops.row_norms.launches, ops.fused_sampled_dw.launches) == (r0, f0)
    assert row_norms.row_norms is ops.row_norms
