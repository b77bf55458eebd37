"""The port's flash attention kernel wrapper against the JAX package: its
plain version (what the wrapper runs on a CPU tensor) against the jnp
oracle ``repro.kernels.ref.flash_attention_fwd_ref`` and against the
Pallas kernel run through the interpreter, on the same numpy inputs; the
wrapper's refusals; and the prefill's use of it.  The CUDA kernel itself
is held against the same plain version on the card by ``chip_smoke.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models.registry import get_config

torch.set_num_threads(1)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: the reference's own flash tolerance (tests/test_kernels.py); bf16:
# its bf16 tolerance, which covers the output's one rounding to bf16
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _qkv(bh, group, sq, skv, dh, dtype, seed=7):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(bh, sq, dh), rng.randn(bh // group, skv, dh),
              rng.randn(bh // group, skv, dh)]
    arrays = [a.astype(np.float32) for a in arrays]
    return ([jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


# (BH, Sq, Skv, Dh, bq, bk): the reference sweep's shape, Sq != Skv (the
# causal mask aligned at position 0) and an odd length, each with Pallas
# blocks that tile it; zamba2's head dim 80 and 72 (a multiple of 8, not
# of 16), which the card's wgmma route holds in a 128-column tile
SHAPES = [(4, 64, 64, 16, 16, 16), (4, 32, 64, 16, 16, 16),
          (4, 50, 50, 16, 50, 50), (4, 64, 64, 80, 16, 16),
          (4, 50, 50, 72, 50, 50)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,skv,dh,bq,bk", SHAPES)
def test_flash_matches_oracle_and_interpreted_pallas(bh, sq, skv, dh, bq, bk,
                                                     causal, group, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(bh, group, sq, skv, dh, dtype)
    got = ops.flash_attention_fwd(tq, tk, tv, group=group, causal=causal)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (bh, sq, dh)
    want = jax_ref.flash_attention_fwd_ref(jq, jk, jv, group=group,
                                           causal=causal)
    pallas = jax_ops.flash_attention_fwd(jq, jk, jv, group=group,
                                         causal=causal, bq=bq, bk=bk)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])


def test_causal_mask_is_aligned_at_position_zero():
    """Sq < Skv: query i sees keys 0..i only (not the last Sq keys), so the
    first row is exactly v of the first key."""
    _, (q, k, v) = _qkv(2, 1, 4, 9, 8, "float32", seed=1)
    got = ops.flash_attention_fwd(q, k, v, causal=True)
    np.testing.assert_array_equal(got[:, 0].numpy(), v[:, 0].numpy())
    late = k.clone()
    late[:, 4:] = 1e3            # keys no query of the 4 can see
    again = ops.flash_attention_fwd(q, late, v, causal=True)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_gqa_rows_read_their_own_kv_head():
    """BH = BKVH * group: query head h reads kv head h // group (the
    Pallas kernel's index map), the same as a repeated K/V copy."""
    _, (q, k, v) = _qkv(6, 3, 10, 10, 16, "float32", seed=2)
    got = ops.flash_attention_fwd(q, k, v, group=3)
    rep = [t.repeat_interleave(3, dim=0).contiguous() for t in (k, v)]
    want = ops.flash_attention_fwd(q, *rep, group=1)
    # the same arithmetic on the same values: bit-identical
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _ok():
    return [torch.zeros(4, 8, 16), torch.zeros(2, 8, 16),
            torch.zeros(2, 8, 16)]


@pytest.mark.parametrize("which,change,error", [
    (0, lambda t: t.to(torch.float64), TypeError),          # q dtype
    (0, lambda t: t.to(torch.int32), TypeError),
    (1, lambda t: t.to(torch.bfloat16), TypeError),         # k dtype
    (2, lambda t: t.to(torch.float16), TypeError),          # v dtype
    (0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),                                           # strides
    (1, lambda t: torch.zeros(2, 16, 16)[:, ::2], ValueError),
    (1, lambda t: torch.zeros(3, 8, 16), ValueError),       # BH % BKVH
    (2, lambda t: t[:, :4].contiguous(), ValueError),       # v shape
    (0, lambda t: t[0], ValueError),                        # rank
])
def test_wrapper_refuses_what_the_kernel_does_not_take(which, change, error):
    args = _ok()
    args[which] = change(args[which])
    with pytest.raises(error):
        ops.flash_attention_fwd(*args, group=2)


@pytest.mark.parametrize("dh", [4, 12, 264])
def test_wrapper_refuses_head_dims_outside_the_kernel(dh):
    q, k, v = (torch.zeros(n, 8, dh) for n in (2, 2, 2))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_fwd(q, k, v)


def test_wrapper_refuses_a_wrong_group_and_empty_sequences():
    q, k, v = _ok()
    with pytest.raises(ValueError, match="BKVH"):
        ops.flash_attention_fwd(q, k, v, group=1)
    with pytest.raises(ValueError, match="non-empty"):
        ops.flash_attention_fwd(q[:, :0], k, v, group=2)


def test_no_launch_counted_on_cpu():
    before = ops.flash_attention_fwd.launches
    ops.flash_attention_fwd(*_ok(), group=2)
    assert ops.flash_attention_fwd.launches == before
    assert flash_attention.flash_attention_fwd is ops.flash_attention_fwd


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm-2b"])
def test_prefill_runs_its_attention_through_the_kernel_wrapper(arch,
                                                               monkeypatch):
    """One wrapper call per layer, on the (B*H, S, Dh) layout with the
    model's GQA group."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    params = lm.init_params(cfg, 0, device="cpu")
    calls = []
    real = ops.flash_attention_fwd

    def spy(q, k, v, *, group, causal):
        calls.append((tuple(q.shape), tuple(k.shape), group, causal))
        return real(q, k, v, group=group, causal=causal)

    monkeypatch.setattr(ops, "flash_attention_fwd", spy)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        lm.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                   cm.Policy())
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert calls == [((2 * h, 24, dh), (2 * kvh, 24, dh), h // kvh, True)
                     ] * cfg.n_layers
