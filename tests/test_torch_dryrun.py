"""The dry run: ``launch/cost.py``, the kernels' ``meta`` paths,
``launch/dryrun.py``, ``launch/roofline.py`` and the report's §Dry-run /
§Roofline text.

``CostCounter`` is held to the reference's ``TestHloCost`` numbers
(``tests/test_sharding.py``) and, on the same jax programs, to the
reference's ``hlo_cost.module_cost``; each kernel's ``meta`` output to
its plain version's shape and dtype and its charge to the bound formulas
``chip_smoke.py`` holds the kernels to; a reduced arch's per-device
argument bytes on a 2 x 2 mesh to the reference's ``NamedSharding``
shard shapes; the roofline and report text to the reference's on the
same record, character for character, with the H100's constants in place
of the TPU's (``trace s`` where the reference has ``compile s``).  The
reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so it
is not imported here."""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.launch import hlo_cost
from repro.launch import report as jax_report
from repro.launch import roofline as jax_roofline
from repro.launch import train_steps as jax_train_steps
from repro_torch.configs.base import InputShape
from repro_torch.kernels import costs, ops
from repro_torch.kernels.flash_attention import flash_attention_fwd_plain
from repro_torch.kernels.fused_sampling import fused_sampled_dw_plain
from repro_torch.kernels.gather_scale import gather_scale_plain
from repro_torch.kernels.row_norms import row_norms_plain
from repro_torch.kernels.sampled_matmul import sampled_matmul_plain
from repro_torch.launch import cost, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import report, roofline
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.models.registry import get_config

torch.set_num_threads(1)

META = dict(device="meta")


# ---------------------------------------------------------------------------
# cost.py against the reference's TestHloCost
# ---------------------------------------------------------------------------

def _count(fn, *args):
    with cost.CostCounter() as c:
        fn(*args)
    return c


def test_loop_of_matmuls_is_exact():
    L, M, K = 5, 32, 64
    ws = torch.empty((L, K, K), **META)
    x = torch.empty((M, K), **META)

    def f(ws, x):
        for i in range(L):
            x = x @ ws[i]
        return x.sum()

    assert _count(f, ws, x).flops == L * 2 * M * K * K

    def jf(ws, x):
        y, _ = jax.lax.scan(lambda x, w: (jnp.dot(x, w), None), x, ws)
        return jnp.sum(y)

    hc = hlo_cost.module_cost(jax.jit(jf).lower(
        jnp.zeros((L, K, K)), jnp.zeros((M, K))).compile().as_text())
    # the reference's own tolerance on its walker
    assert hc.flops == pytest.approx(L * 2 * M * K * K, rel=0.01)


def test_gradient_of_the_loop_triples_the_flops():
    L, M, K = 4, 16, 32
    ws = torch.empty((L, K, K), requires_grad=True, **META)
    x0 = torch.empty((M, K), requires_grad=True, **META)

    def f(ws, x):
        for i in range(L):
            x = x @ ws[i]
        torch.autograd.grad(x.sum(), (ws, x0))

    # forward, then dX and dW of every product in the backward: exactly 3x
    assert _count(f, ws, x0).flops == 3 * L * 2 * M * K * K


def test_nested_loops_multiply():
    x = torch.empty((16, 16), **META)

    def f(c):
        for _ in range(4):
            for _ in range(3):
                c = torch.tanh(c @ c)
        return c

    assert _count(f, x).flops == 12 * 2 * 16 ** 3


def test_folded_loop_counts_every_trip_but_not_the_peak():
    x = torch.empty((64, 64), **META)

    def body(folded):
        with cost.CostCounter(fold_loops=folded) as c:
            acc = torch.zeros((64, 64), **META)
            for _ in cost.loop(8):
                acc = acc + (x @ x)
        return c

    one, all_ = body(True), body(False)
    assert one.flops == all_.flops == 8 * 2 * 64 ** 3
    assert one.bytes_accessed == all_.bytes_accessed
    assert one.peak == all_.peak
    assert list(cost.loop(3)) == [0, 1, 2]       # no counter: range


def test_peak_follows_allocation_and_release():
    n = 1 << 20
    arg = torch.empty((n,), **META)
    with cost.CostCounter() as c:
        c.track(arg)                           # 4 MiB of arguments
        a = torch.ones((n,), **META)           # 8 MiB live
        b = a * 2                              # 12 MiB live: the peak
        del a                                  # 8
        d = b + 1                              # 12
        del b, d                               # 4
        e = torch.ones((n,), dtype=torch.float64, **META)   # 12
    assert c.argument_bytes == 4 * n
    assert c.peak == 12 * n
    assert c.live == 12 * n                    # arg and e still held
    del e


def test_bytes_count_inputs_and_outputs_not_views():
    x = torch.empty((128, 64), **META)
    with cost.CostCounter() as c:
        y = x.t()                              # a view: nothing moved
        z = y.contiguous()                     # read 32 KiB, write 32 KiB
    assert c.bytes_accessed == 2 * 128 * 64 * 4
    assert z.shape == (64, 128)


# ---------------------------------------------------------------------------
# the kernels' meta paths
# ---------------------------------------------------------------------------

def _meta_like(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_meta_match_their_plain_versions_and_charge_their_bounds(
        dtype):
    g = torch.Generator().manual_seed(0)
    b, n, k, d_in, d_out, e = 2, 24, 7, 40, 24, 3
    item = torch.finfo(dtype).bits // 8
    x = torch.randn((b * n, d_in), generator=g).to(dtype)
    h = torch.randn((b, n, d_in), generator=g).to(dtype)
    idx = torch.randint(0, n, (b, k), generator=g).to(torch.int32)
    scale = torch.rand((b, k), generator=g)
    hsub = torch.randn((b, k, d_in), generator=g).to(dtype)
    dz = torch.randn((b, n, d_out), generator=g).to(dtype)
    q = torch.randn((8, 32, 64), generator=g).to(dtype)
    kv = torch.randn((2, 32, 64), generator=g).to(dtype)
    ex = [torch.stack([t] * e) for t in (hsub, dz, idx, scale)]
    cases = [
        # (wrapper, plain, args, flops, bytes) — the formulas chip_smoke.py
        # bounds each kernel by: each input read once, each output written
        # once; B*k source rows where the plan's distinct rows are unknown
        (ops.row_norms, row_norms_plain, (x,), 2 * b * n * d_in,
         b * n * d_in * item + 4 * b * n),
        (ops.gather_scale, gather_scale_plain, (h, idx, scale),
         b * k * d_in, item * d_in * (b * k + b * k) + 8 * b * k),
        (ops.fused_sampled_dw, fused_sampled_dw_plain,
         (hsub, dz, idx, scale), 2 * b * k * d_in * d_out,
         item * (b * k * d_in + b * k * d_out) + 8 * b * k
         + 4 * d_in * d_out),
        (ops.fused_sampled_dw, fused_sampled_dw_plain, tuple(ex),
         2 * e * b * k * d_in * d_out,
         item * (e * b * k * d_in + e * b * k * d_out) + 8 * e * b * k
         + 4 * e * d_in * d_out),
        (ops.sampled_matmul, sampled_matmul_plain,
         (hsub, dz, idx, scale), 2 * b * k * d_in * d_out,
         item * (b * k * d_in + b * k * d_out) + 8 * b * k
         + 4 * d_in * d_out),
        (ops.flash_attention_fwd, flash_attention_fwd_plain, (q, kv, kv),
         4 * 8 * 64 * sum(min(i + 1, 32) for i in range(32)),
         (2 * 8 * 32 + 2 * 2 * 32) * 64 * item),
    ]
    for fn, plain, args, flops, nbytes in cases:
        kw = {"group": 4} if fn is ops.flash_attention_fwd else {}
        want = plain(*args, **kw)
        launches, metas = fn.launches, fn.meta_launches
        charged = []
        costs.sinks.append(lambda name, f, nb: charged.append((name, f, nb)))
        try:
            got = fn(*[_meta_like(t) for t in args], **kw)
        finally:
            costs.sinks.pop()
        assert got.device.type == "meta", fn.__name__
        assert (got.shape, got.dtype) == (want.shape, want.dtype), \
            fn.__name__
        assert charged == [(fn.__name__, flops, nbytes)], fn.__name__
        assert fn.meta_launches == metas + 1
        assert fn.launches == launches          # the real count is untouched


def test_flash_visible_keys_closed_form():
    for sq, skv in ((1, 1), (7, 7), (5, 9), (9, 5), (64, 16)):
        for causal in (True, False):
            want = (sum(min(i + 1, skv) for i in range(sq)) if causal
                    else sq * skv)
            assert costs.flash_visible(sq, skv, causal) == want


# ---------------------------------------------------------------------------
# per-device bytes against the reference's shard shapes
# ---------------------------------------------------------------------------

SMALL = InputShape("small_train", 64, 8, "train")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b", "xlstm-125m",
                                  "whisper-base"])
def test_argument_bytes_equal_the_reference_shard_shapes(arch):
    cfg = get_config(arch, reduced=True)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
    counter, _, _ = dryrun.trace_step(cfg, SMALL, mesh, dryrun.exact_policy())
    jcfg = jax_get_config(arch, reduced=True)
    ref, ref_axes = jax_train_steps.abstract_train_state(jcfg)
    amesh = AbstractMesh((2, 2), ("data", "model"))
    sh = jax_train_steps.train_state_shardings(jcfg, ref, ref_axes, amesh)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    shardings = jax.tree_util.tree_leaves(
        sh, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    assert len(leaves) == len(shardings)
    # the reference's step, Adam's count and its PRNG key are host
    # integers in the port (``step``, ``count``, ``base_seed``); every other
    # leaf is a tensor of its shard
    host = ("['step']", "['base_key']", ".count")
    want = sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for (path, x), s in zip(leaves, shardings)
               if not jax.tree_util.keystr(path).endswith(host))
    # the batch (tokens and labels, int32; an enc-dec's frames too), split
    # over the 2 data ranks
    want += sum(int(np.prod(shape)) * dtype.itemsize for shape, dtype in
                registry.train_batch_specs(cfg, SMALL.global_batch // 2,
                                           SMALL.seq_len).values())
    assert counter.argument_bytes == want


# ---------------------------------------------------------------------------
# lower_cell records
# ---------------------------------------------------------------------------

def _reduced_cell(arch, shape, multi=False, **kw):
    return dryrun.lower_cell(arch, shape, multi,
                             cfg=get_config(arch, reduced=True), **kw)[0]


REF_KEYS = {"arch", "shape", "mesh", "status", "seq_len", "global_batch",
            "kind", "n_params", "n_active_params"}


@pytest.mark.parametrize("arch,shape,multi", [
    ("qwen2.5-3b", "prefill_32k", False),
    ("granite-moe-1b-a400m", "decode_32k", True),
    ("minicpm-2b", "decode_32k", False)])
def test_serving_cells_trace_on_the_production_meshes(arch, shape, multi):
    rec = _reduced_cell(arch, shape, multi)
    assert rec["status"] == "ok"
    assert REF_KEYS | {"trace_s", "memory", "cost", "collectives"} <= \
        set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_per_device_bytes"}
    assert rec["cost"]["xla_flops_loopbody_once"] is None
    assert rec["collectives"]["loopbody_once"] is None
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    # every serving step gathers the logits over model; decode all-reduces
    # its softmax parts over the cache's sequence shards
    counts = rec["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    if shape.startswith("prefill"):
        assert rec["kernels"]["launches"]["flash_attention_fwd"] == \
            get_config(arch, reduced=True).n_layers
    json.dumps(rec)


def test_minicpm_record_says_how_q_is_split():
    cfg = get_config("minicpm-2b")
    notes = dryrun.model_axis_notes(cfg, mesh_lib.make_production_mesh())
    assert notes == {"q_heads": "sliced through heads: q all-gathered "
                                "before the scores",
                     "kv_heads": "replicated"}


def test_skipped_and_error_cells(tmp_path):
    rec, _, _ = dryrun.lower_cell("qwen2.5-3b", "long_500k", False)
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]
    # a trace that raises is recorded, as the reference records a failed
    # lowering: here a remat mode the model does not know
    out = dryrun.run_cells([("qwen2.5-3b", "train_4k", False)],
                           out_dir=str(tmp_path),
                           policy=cm.Policy(remat="nowhere"))
    assert out[0]["status"] == "error" and "nowhere" in out[0]["error"]
    assert (tmp_path / "qwen2.5-3b__train_4k__single.json").exists()


@pytest.mark.parametrize("arch,shape,reduced", [
    ("xlstm-125m", "decode_32k", False), ("zamba2-2.7b", "decode_32k", False),
    ("zamba2-2.7b", "prefill_32k", True), ("whisper-base", "train_4k", False)])
def test_recurrent_and_encdec_cells_trace_on_the_production_mesh(
        arch, shape, reduced):
    cfg = get_config(arch, reduced=reduced)
    rec = dryrun.lower_cell(arch, shape, False, cfg=cfg)[0]
    assert rec["status"] == "ok"
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["total_bytes"] > 0
    # 16 model ranks: zamba2's 80 Mamba2 heads and its state width of 64
    # split (the reduced arch's 8 heads do not), xlstm-125m's 4 heads do
    # not: every rank runs every head
    split = arch == "zamba2-2.7b" and not reduced
    for btype in set(cfg.pattern) & {"mamba", "mlstm", "slstm"}:
        assert rec["model_axis"][btype] == (
            "heads split over model" if split else
            "gathered: every rank runs every head")
    json.dumps(rec)


def test_production_records_say_how_the_blocks_split():
    mesh = mesh_lib.make_production_mesh()
    gathered = "gathered: every rank runs every head"
    assert dryrun.model_axis_notes(get_config("xlstm-125m"), mesh) == {
        "mlstm": gathered, "slstm": gathered}
    assert dryrun.model_axis_notes(get_config("zamba2-2.7b"), mesh) == {
        "mamba": "heads split over model"}
    assert dryrun.model_axis_notes(get_config("whisper-base"), mesh) == {
        "q_heads": "sliced through heads: q all-gathered before the scores",
        "kv_heads": "replicated"}


def test_train_cell_folds_the_microbatches():
    cfg = get_config("qwen2.5-3b", reduced=True)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
    pol = dryrun.dryrun_policy()
    two, _, _ = dryrun.trace_step(cfg, SMALL, mesh, pol, microbatches=2)
    one, _, _ = dryrun.trace_step(cfg, dataclasses.replace(
        SMALL, global_batch=SMALL.global_batch // 2), mesh, pol)
    # two microbatches traced as one and counted twice: the kernels of
    # every plan, the flops of the products and the collectives of the
    # model axis twice those of one microbatch's step; the data axis's
    # gradient all-reduce once either way
    assert two.launches == {k: 2 * v for k, v in one.launches.items()}
    assert two.launches["row_norms"] == two.launches["gather_scale"] > 0
    assert two.flops > 1.9 * one.flops
    assert two.peak < 1.5 * one.peak


# ---------------------------------------------------------------------------
# roofline and report text against the reference's
# ---------------------------------------------------------------------------

RECORD = {
    "arch": "qwen2.5-3b", "shape": "train_4k", "mesh": "single",
    "status": "ok", "seq_len": 4096, "global_batch": 256, "kind": "train",
    "n_params": 3_085_938_688, "n_active_params": 3_085_938_688,
    "compile_s": 12.5,
    "memory": {"argument_bytes": 2_000_000_000, "output_bytes": 1_900_000_000,
               "temp_bytes": 9_000_000_000, "alias_bytes": 1_900_000_000,
               "peak_per_device_bytes": 11_000_000_000},
    "cost": {"flops": 1.23e14, "bytes_accessed": 6.5e11},
    "collectives": {"total_bytes": 6.2e10,
                    "counts": {"all-gather": 32, "all-reduce": 900,
                               "reduce-scatter": 0, "all-to-all": 0,
                               "collective-permute": 0}},
}
OTHER = dict(RECORD, arch="dbrx-132b", n_active_params=36_000_000_000,
             cost={"flops": 4.1e14, "bytes_accessed": 2.2e12},
             collectives=dict(RECORD["collectives"], total_bytes=9.9e10))
SKIPPED = {"arch": "qwen2.5-3b", "shape": "long_500k", "mesh": "single",
           "status": "skipped", "reason": "pure full-attention architecture"}


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's roofline module with the H100's constants."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jax_roofline, name, getattr(roofline, name))
    return jax_roofline


def test_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)
    assert roofline.CHIPS == jax_roofline.CHIPS == {"single": 256,
                                                    "multi": 512}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_is_the_references(kind):
    rec = dict(RECORD, kind=kind)
    assert roofline.model_flops(rec) == jax_roofline.model_flops(rec)


def test_roofline_terms_and_markdown_are_the_references(h100_reference):
    for rec in (RECORD, OTHER, dict(RECORD, mesh="multi")):
        assert roofline.roofline_terms(rec) == \
            h100_reference.roofline_terms(rec)
    rows = [dict(r, status="ok", mem_gib=1.0, **roofline.roofline_terms(r))
            for r in (RECORD, OTHER)]
    rows.append({**SKIPPED})
    assert roofline.to_markdown(rows) == h100_reference.to_markdown(rows)
    ok = rows[:2]
    assert roofline.pick_hillclimb_cells(ok) == \
        h100_reference.pick_hillclimb_cells(ok)


def test_dryrun_table_is_the_references():
    recs = [RECORD, OTHER, SKIPPED,
            {"arch": "zamba2-2.7b", "shape": "train_4k", "mesh": "single",
             "status": "error", "error": "NotImplementedError: A.12"}]
    want = jax_report.dryrun_table(recs).replace("compile s", "trace s")
    assert report.dryrun_table(recs) == want
    port = dict(RECORD, trace_s=RECORD["compile_s"])
    del port["compile_s"]
    assert report.dryrun_table([port]) == \
        jax_report.dryrun_table([RECORD]).replace("compile s", "trace s")


def test_run_report_roofline_section_is_the_references(h100_reference):
    kw = dict(n_steps=3, budget_records=[], n_compiles=1,
              history=[{"loss": 2.0}, {"loss": 1.5}])
    got = report.run_report(roofline_rec=RECORD, **kw)
    assert got == jax_report.run_report(roofline_rec=RECORD, **kw)
    assert "## §Roofline" in got
    assert "## §Roofline" not in report.run_report(roofline_rec=SKIPPED,
                                                   **kw)


def test_load_records_summarize_and_generate(tmp_path, h100_reference):
    for rec in (RECORD, OTHER, SKIPPED):
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        (tmp_path / name).write_text(json.dumps(rec))
    (tmp_path / "x__y__single__tagged.json").write_text(json.dumps(RECORD))
    rows = roofline.summarize(str(tmp_path))
    assert rows == h100_reference.summarize(str(tmp_path))
    assert len(rows) == 3
    text = report.generate(str(tmp_path))
    assert "## §Dry-run" in text and "## §Roofline" in text
    assert "989.4" in text or "9.894e+14" in text


def test_the_command_line_writes_a_record(tmp_path):
    done = subprocess.run(
        [sys.executable, "-c",
         "import sys; from repro_torch.launch import dryrun;"
         "from repro_torch.configs import get_config;"
         "dryrun.get_config = lambda a: get_config(a, reduced=True);"
         "dryrun.main(sys.argv[1:])",
         "--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh",
         "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(__import__("pathlib").Path(__file__)
                               .resolve().parents[1] / "src"),
             "PATH": "/usr/bin:/bin"})
    assert done.returncode == 0, done.stderr[-3000:]
    rec = json.loads((tmp_path / "qwen2.5-3b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and "1 ok, 0 skipped, 0 errors" in \
        done.stdout
