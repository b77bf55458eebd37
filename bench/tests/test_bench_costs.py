"""The frozen cost arithmetic against counts made by hand."""
import costs


def test_budget_rows():
    assert costs.budget_rows(0.3, 2048) == 614
    assert costs.budget_rows(0.3, 4096) == 1229
    assert costs.budget_rows(0.3, 16) == 8          # at least min_rows
    assert costs.budget_rows(0.9, 4) == 4           # at most the rows


def test_dw_bound_by_hand():
    # B=16, k=614, 6144 x 24576 in bf16: 2·B·k·d_in·d_out flops, and
    # H' + the plan's dZ rows + idx/scale + the f32 dW in bytes
    flops = 2 * 16 * 614 * 6144 * 24576
    nbytes = 2 * (9824 * 6144 + 9824 * 24576) + 8 * 9824 + 4 * 6144 * 24576
    assert nbytes == 1207644928
    want = max(flops / 989.4e12, nbytes / 3.35e12)
    assert want == flops / 989.4e12                 # bound by operations
    assert costs.dw_bound(16, 614, 6144, 24576) == want


def test_flash_bound_by_hand():
    # 32 prompts of 4096, 48 heads over 8 kv heads, Dh 128, causal
    visible = 4096 * 4097 // 2
    flops = 4 * (32 * 48) * 128 * visible
    nbytes = (2 * 32 * 48 * 4096 + 2 * 32 * 8 * 4096) * 128 * 2
    assert costs.flash_bound(32 * 48, 32 * 8, 4096, 4096, 128) == max(
        flops / 989.4e12, nbytes / 3.35e12)


TINY = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
        "d_head": 2, "d_ff": 8, "vocab_size": 10, "pattern": ["attn"],
        "mlp_type": "relu2"}
CELL = {"batch": 2, "seq": 32, "estimator": "wta_crs", "budget": 0.5}


def test_train_step_flops_by_hand():
    # linears q 4x4, k 4x2, v 4x2, o 4x4, wi 4x8, wo 8x4: Σ d_in·d_out 112
    fwd_dx = 4 * 64 * 112                  # B·S = 64 rows, forward + dX
    dw = 2 * 2 * 16 * 112                  # k = 16 rows a sequence
    head = 6 * 64 * 4 * 10
    attn = 3 * 4 * 2 * 2 * 2 * (32 * 33 // 2)   # fwd + 2x bwd, causal half
    assert costs.train_step_flops(TINY, CELL) == fwd_dx + dw + head + attn
    exact = dict(CELL, estimator="exact")
    assert costs.train_step_flops(TINY, exact) == \
        6 * 64 * 112 + head + attn


def test_prefill_flops_by_hand():
    assert costs.prefill_flops(TINY, CELL) == \
        2 * 64 * 112 + 2 * 2 * 4 * 10 + 4 * 2 * 2 * 2 * (32 * 33 // 2)


def test_ssd_flops_by_hand():
    conf = {"d_model": 4, "ssm_expand": 2, "ssm_head_dim": 4,
            "ssm_state": 3}
    # inner 8 = 2 heads of 4, state 3; one sequence of 8 in chunks of 4:
    # 2 chunks x 10 causal pairs x (C·Bᵀ over 3 + scores·x over 2x4),
    # then chunk states and their read-out: 2 x 2·S·N·H·P
    assert costs.ssd_forward_flops(conf, 1, 8, chunk=4) == \
        2 * 20 * (3 + 8) + 4 * 8 * 3 * 2 * 4


def test_step_dw_bound_sums_every_sampled_product():
    conf = dict(TINY, d_model=64, d_head=32, d_ff=128)
    want = sum(costs.dw_bound(2, 16, a, b) for a, b in
               [(64, 64), (64, 32), (64, 32), (64, 64), (64, 128), (128, 64)])
    assert costs.step_dw_bound(conf, CELL) == want
    assert costs.step_dw_bound(conf, dict(CELL, estimator="exact")) == 0.0
