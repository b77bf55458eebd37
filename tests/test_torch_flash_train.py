"""The training attention on hand-written kernels: ``kernels/
flash_attention.py::FlashAttention`` (``flash_attention_fwd`` forward,
``flash_attention_bwd`` backward) and the rule by which ``models/
attention.py::flash_attention`` takes it.

On the CPU the Function runs the kernels' plain versions, whose
arithmetic is the kernels' own (the scores and each row's log-sum-exp
recomputed, D = rowsum(P * dP), dS in two halves of the input dtype, dK
and dV summed over the group, each gradient rounded once); they are held
against autograd of the eager blockwise ``flash_attention`` and against
``attention_reference`` in f32.  The tests marked ``cuda`` hold the
kernels themselves on the card (``python -m pytest -m cuda
tests/test_torch_flash_train.py`` there); they skip elsewhere.

This file imports no JAX: the card's tests run where there is none.
"""
import math

import pytest
import torch

from repro_torch.kernels import costs
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

# (B, H, KVH, Sq, Skv, Dh, causal): G 1 and 6, Sq = Skv and not, ragged
# lengths, Dh 16, 64, 80 and 128, one query row (a decoder's first token
# over an encoder's frames)
SHAPES = [
    (2, 4, 4, 32, 32, 16, True),
    (1, 6, 1, 32, 32, 64, True),
    (1, 6, 1, 24, 40, 80, True),
    (1, 6, 1, 40, 24, 128, True),
    (2, 4, 4, 30, 50, 64, False),
    (1, 6, 1, 17, 23, 128, False),
    (1, 2, 2, 1, 45, 16, False),
    (1, 12, 2, 33, 33, 80, False),
]


def _inputs(b, h, kvh, sq, skv, dh, dtype, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(device=device,
                                                     dtype=dtype)
    return (rnd(b, sq, h, dh), rnd(b, skv, kvh, dh), rnd(b, skv, kvh, dh),
            rnd(b, sq, h, dh))


def _grads(fn, q, k, v, do):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    return (out,) + torch.autograd.grad(out, (q, k, v), do)


def _reference(q, k, v, do, causal):
    """Output and gradients of ``attention_reference`` in f32."""
    return _grads(lambda a, b, c: attn.attention_reference(
        a, b, c, causal=causal), q.float(), k.float(), v.float(), do.float())


def _eager(q, k, v, do, causal):
    """Autograd of the eager blockwise path, one block a sequence (its
    lengths need not tile by 512)."""
    return _grads(lambda a, b, c: attn.flash_attention(
        a, b, c, causal=causal, q_block=a.shape[1], kv_block=b.shape[1]),
        q, k, v, do)


def _pair(q, k, v, do, causal):
    return _grads(lambda a, b, c: fk.FlashAttention.apply(a, b, c, causal),
                  q, k, v, do)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_pair_matches_eager_autograd_and_reference_in_f32(shape):
    *dims, causal = shape
    q, k, v, do = _inputs(*dims, torch.float32)
    got = _pair(q, k, v, do, causal)
    # f32 everywhere: the three differ by summation order alone
    for want in (_eager(q, k, v, do, causal), _reference(q, k, v, do,
                                                         causal)):
        for a, b in zip(got, want):
            assert _err(a, b) <= 2e-5 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_pair_in_bf16_is_as_close_to_f32_as_the_eager_path(shape):
    *dims, causal = shape
    q, k, v, do = _inputs(*dims, torch.bfloat16)
    ref = _reference(q, k, v, do, causal)
    got = _pair(q, k, v, do, causal)
    eager = _eager(q, k, v, do, causal)
    for name, a, e, r in zip(("out", "dq", "dk", "dv"), got, eager, ref):
        scale = max(1.0, float(r.abs().max()))
        # one bf16 rounding of each gradient (2^-8 of its largest value)
        # plus the rounding of P before P V, which the forward shares with
        # the eager path; the eager path also rounds dP to bf16, the pair
        # keeps it in f32, so the pair is no farther from f32 than it
        assert _err(a, r) <= 1.6e-2 * scale, name
        assert _err(a, r) <= _err(e, r) + 4e-3 * scale, name


def test_ds_enters_dk_and_dq_in_two_halves():
    """dQ is round(scale * (hi K + lo K)) with hi = round(dS), lo =
    round(dS - hi) in bf16: about 16 significant bits of dS, where hi alone
    (dS rounded to bf16) is a coarser result by some 2^8."""
    q, k, v, do = (t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])
                   .contiguous() for t in _inputs(1, 6, 1, 64, 64, 64,
                                                  torch.bfloat16))
    dq, _, _ = fk.flash_attention_bwd_plain(q, k, v, do, group=6)
    kk = torch.repeat_interleave(k.float(), 6, 0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), kk) * 0.125
    s = s.masked_fill(~torch.tril(torch.ones(64, 64, dtype=torch.bool)),
                      -math.inf)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    dp = torch.einsum("hqd,hkd->hqk", do.float(),
                      torch.repeat_interleave(v.float(), 6, 0))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    hi = ds.bfloat16().float()
    lo = (ds - hi).bfloat16().float()
    two = (torch.einsum("hqk,hkd->hqd", hi, kk)
           + torch.einsum("hqk,hkd->hqd", lo, kk)) * 0.125
    assert torch.equal(dq, two.bfloat16())
    exact = torch.einsum("hqk,hkd->hqd", ds, kk) * 0.125
    one = torch.einsum("hqk,hkd->hqd", hi, kk) * 0.125
    assert _err(two, exact) * 64 < _err(one, exact)


def test_function_saves_q_k_v_alone():
    """One heads-first copy each of q, k and v: no output, no statistics,
    no probabilities."""
    q, k, v, _ = _inputs(2, 6, 2, 24, 24, 16, torch.bfloat16)
    saved = []
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        fk.FlashAttention.apply(q, k, v, True)
    assert [tuple(t.shape) for t in saved] == [(12, 24, 16), (4, 24, 16),
                                               (4, 24, 16)]
    assert all(t.is_contiguous() and t.dtype == torch.bfloat16
               for t in saved)


@pytest.mark.parametrize("device,dtype,dh,q_offset,want", [
    ("cpu", torch.bfloat16, 128, 0, False),
    ("meta", torch.bfloat16, 128, 0, True),
    ("meta", torch.float16, 80, 0, True),
    ("meta", torch.bfloat16, 16, 0, True),
    ("meta", torch.float32, 128, 0, False),
    ("meta", torch.bfloat16, 136, 0, False),
    ("meta", torch.bfloat16, 12, 0, False),
    ("meta", torch.bfloat16, 128, 64, False),
])
def test_train_route_by_what_the_call_shows(device, dtype, dh, q_offset,
                                            want):
    q = torch.empty((2, 8, 4, dh), dtype=dtype, device=device)
    k = torch.empty((2, 8, 2, dh), dtype=dtype, device=device)
    assert fk.train_route(q, k, q_offset) is want


def test_cpu_keeps_the_eager_path_and_counts_no_launch():
    q, k, v, do = _inputs(1, 4, 2, 32, 32, 64, torch.bfloat16)
    before = (ops.flash_attention_fwd.launches,
              ops.flash_attention_bwd.launches)
    _grads(lambda a, b, c: attn.flash_attention(
        a, b, c, q_block=16, kv_block=16), q, k, v, do)
    # the eager path's own rule stands on the CPU: lengths tile by blocks
    with pytest.raises(ValueError, match="must tile"):
        attn.flash_attention(q, k, v, q_block=12, kv_block=12)
    fk.flash_attention_bwd(*(t.transpose(1, 2).reshape(-1, 32, 64)
                             .contiguous() for t in (q, k[:, :, :1],
                                                     v[:, :, :1], do)),
                           group=4)
    assert (ops.flash_attention_fwd.launches,
            ops.flash_attention_bwd.launches) == before


def test_meta_attention_charges_both_kernels():
    """The dry run of a card's step: ``flash_attention`` on ``meta`` takes
    the Function, whose forward and backward each charge one meta launch
    of their kernel and its ``kernels/costs.py`` work."""
    b, h, kvh, s, dh = 2, 6, 2, 40, 64
    q = torch.empty((b, s, h, dh), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k = torch.empty((b, s, kvh, dh), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    charged = []
    costs.sinks.append(lambda name, f, nb: charged.append((name, f, nb)))
    launches = (ops.flash_attention_fwd.launches,
                ops.flash_attention_bwd.launches)
    metas = ops.flash_attention_bwd.meta_launches
    try:
        out = attn.flash_attention(q, k, v, causal=True)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    finally:
        costs.sinks.pop()
    assert charged == [
        ("flash_attention_fwd",
         *costs.flash(b * h, b * kvh, s, s, dh, True, 2)),
        ("flash_attention_bwd",
         *costs.flash_bwd(b * h, b * kvh, s, s, dh, True, 2))]
    assert ops.flash_attention_bwd.meta_launches == metas + 1
    assert (ops.flash_attention_fwd.launches,
            ops.flash_attention_bwd.launches) == launches


@pytest.mark.parametrize("route", [True, False])
def test_flash_attention_reads_train_route_at_call(monkeypatch, route):
    """``flash_attention`` looks ``train_route`` up on the kernels' module
    at every call: a harness that sets it there to refuse (``chip_smoke.py
    ::eager_attention``) gets the eager path on the card."""
    q = torch.empty((1, 32, 4, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 32, 2, 64), dtype=torch.bfloat16, device="meta")
    metas = ops.flash_attention_fwd.meta_launches
    monkeypatch.setattr(fk, "train_route", lambda *args, **kw: route)
    out = attn.flash_attention(q, k, torch.empty_like(k), q_block=16,
                               kv_block=16)
    assert out.shape == q.shape
    assert ops.flash_attention_fwd.meta_launches == metas + int(route)


def test_bwd_meta_charge_is_twice_the_forward_products():
    bh, bkvh, sq, skv, dh = 12, 2, 33, 70, 128
    args = [torch.empty(shape, dtype=torch.bfloat16, device="meta")
            for shape in ((bh, sq, dh), (bkvh, skv, dh), (bkvh, skv, dh),
                          (bh, sq, dh))]
    charged = []
    costs.sinks.append(lambda name, f, nb: charged.append((name, f, nb)))
    try:
        dq, dk, dv = ops.flash_attention_bwd(*args, group=6, causal=False)
    finally:
        costs.sinks.pop()
    vis = sq * skv
    assert charged == [("flash_attention_bwd", 8.0 * bh * dh * vis,
                        float((3 * bh * sq + 4 * bkvh * skv) * dh * 2))]
    assert charged[0][1] == 2 * costs.flash(bh, bkvh, sq, skv, dh, False,
                                            2)[0]
    assert [(t.shape, t.device.type) for t in (dq, dk, dv)] == [
        (args[0].shape, "meta"), (args[1].shape, "meta"),
        (args[2].shape, "meta")]


def _bwd_args(bh=12, bkvh=2, sq=20, skv=20, dh=64, dtype=torch.bfloat16):
    return {"q": torch.zeros(bh, sq, dh, dtype=dtype),
            "k": torch.zeros(bkvh, skv, dh, dtype=dtype),
            "v": torch.zeros(bkvh, skv, dh, dtype=dtype),
            "do": torch.zeros(bh, sq, dh, dtype=dtype)}


@pytest.mark.parametrize("change,error", [
    ({"do": torch.zeros(12, 21, 64, dtype=torch.bfloat16)}, ValueError),
    ({"do": torch.zeros(12, 20, 64)}, TypeError),
    ({"k": torch.zeros(2, 20, 64)}, TypeError),
    ({"v": torch.zeros(3, 20, 64, dtype=torch.bfloat16)}, ValueError),
    ({"do": torch.zeros(12, 64, 20, dtype=torch.bfloat16).transpose(1, 2)},
     ValueError),
    ({"q": torch.zeros(12, 20, 64, dtype=torch.int32)}, TypeError),
])
def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    args = dict(_bwd_args(), **change)
    with pytest.raises(error):
        ops.flash_attention_bwd(args["q"], args["k"], args["v"], args["do"],
                                group=6)


@pytest.mark.parametrize("kw,error", [
    ({"group": 4}, ValueError),                    # 2 * 4 != 12
    ({"dh": 12}, ValueError),                      # not a multiple of 8
    ({"sq": 0, "group": 6}, ValueError),           # empty
])
def test_bwd_wrapper_refuses_groups_head_dims_and_empty_sequences(kw, error):
    group = kw.pop("group", 6)
    args = _bwd_args(**kw)
    with pytest.raises(error):
        ops.flash_attention_bwd(args["q"], args["k"], args["v"], args["do"],
                                group=group)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no interpret "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", SHAPES + [(2, 6, 1, 333, 200, 128, True),
                                            (1, 4, 4, 200, 333, 80, True),
                                            (1, 3, 3, 65, 1500, 64, False)])
def test_card_kernels_match_the_plain_pair(card, dtype, shape):
    *dims, causal = shape
    q, k, v, do = _inputs(*dims, dtype, device=card)
    got = _pair(q, k, v, do, causal)
    again = _pair(q, k, v, do, causal)
    want = _pair(*(t.cpu() for t in (q, k, v, do)), causal)
    # the same products in another summation order (the tensor cores' f32
    # sums, the tiles' order), then one rounding to the dtype: two ulps of
    # the largest value
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert _err(a.cpu(), b) <= 2 ** -6 * max(1.0, float(b.abs().max())), \
            name
    # no sum crosses blocks: the same bits every run
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_card_function_runs_both_kernels_once(card):
    q, k, v, do = _inputs(2, 8, 2, 256, 256, 128, torch.bfloat16,
                          device=card)
    f0, b0 = ops.flash_attention_fwd.launches, ops.flash_attention_bwd.launches
    out, *grads = _grads(lambda a, b, c: attn.flash_attention(a, b, c),
                         q, k, v, do)
    assert (ops.flash_attention_fwd.launches - f0,
            ops.flash_attention_bwd.launches - b0) == (1, 1)
    ref = _reference(q, k, v, do, True)
    for a, r in zip([out] + grads, ref):
        assert _err(a, r) <= 1.6e-2 * max(1.0, float(r.abs().max()))
    # the forward is the prefill's kernel on heads-first copies, unchanged
    heads = [t.transpose(1, 2).reshape(-1, 256, 128).contiguous()
             for t in (q, k, v)]
    alone = ops.flash_attention_fwd(*heads, group=4, causal=True)
    assert torch.equal(out.transpose(1, 2).reshape(-1, 256, 128), alone)


@pytest.mark.cuda
def test_card_bwd_refuses_float32(card):
    args = {n: t.to(card) for n, t in _bwd_args(dtype=torch.float32).items()}
    with pytest.raises(ValueError, match="wgmma"):
        ops.flash_attention_bwd(args["q"], args["k"], args["v"], args["do"],
                                group=6)


@pytest.mark.cuda
def test_card_remat_full_gives_the_same_gradients(card):
    """``remat="full"`` recomputes each block, the Function's forward
    included, inside the backward: the kernels are deterministic, so the
    gradients are those of ``"none"``."""
    import dataclasses

    from repro_torch.core import WTACRSConfig
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config
    from repro_torch.train import data, optim

    cfg = dataclasses.replace(get_config("qwen2.5-3b", reduced=True),
                              compute_dtype="bfloat16")
    params = lm.init_params(cfg, 0, device=card)
    batch = {n: torch.from_numpy(a).to(card) for n, a in data.SyntheticLM(
        cfg.vocab_size, 64, 8, seed=0).batch_at(0, 2).items()}
    leaves = optim.tree_leaves(params)
    out = {}
    for remat in ("none", "full"):
        policy = cm.Policy(wtacrs=WTACRSConfig(kind="det_topk", budget=0.3,
                                               min_rows=4), remat=remat)
        for p in leaves:
            p.requires_grad_(True)
        b0 = ops.flash_attention_bwd.launches
        loss, _ = lm.lm_loss(cfg, params, batch, policy, key=7)
        out[remat] = torch.autograd.grad(loss, leaves)
        assert ops.flash_attention_bwd.launches - b0 == cfg.n_layers
        for p in leaves:
            p.requires_grad_(False)
    assert all(torch.equal(a, b) for a, b in zip(out["none"], out["full"]))
