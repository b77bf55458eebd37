"""The port's tile autotuner (``repro_torch.kernels.autotune``) against the
reference's (``repro.kernels.autotune``): the same keys and divisors on
the same inputs, deterministic candidates with ties to the first, the
table's round trip and its fallbacks (missing: silent; corrupt, wrong
version or a tile its route does not take: one warning), resolution
pin > table > shape rule worked out once per path and shape, the merge, the packaged table, the tile the
sampled linear's backward hands the kernel, ``sampled_matmul`` at every
pinned tile against the reference's oracle, and the card the measure and
the CLI need.  The tuner's timings themselves are taken on the card by
``chip_smoke.py``'s ``autotune`` phase."""
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_at
from repro.kernels import ref as jax_ref
from repro_torch.api import RunSpec
from repro_torch.core import KernelConfig, WTACRSConfig, linear
from repro_torch.kernels import autotune as at
from repro_torch.kernels import fused_sampling, ops
from repro_torch.kernels import sampled_matmul as smm
from repro_torch.models import common as cm

torch.set_num_threads(1)

ROUTES = ("fma", "wmma", "wgmma")
SHAPE = (256, 256, 8, 77, "bfloat16")     # the reference's bf16 sweep row


def fake_measure(best):
    """Deterministic injected measure: tile ``best`` wins, ties elsewhere."""
    def measure(kernel, tile, d_in, d_out, b, k, dtype):
        return 1.0 if tile == best else 2.0
    return measure


def write_table(path, kernel, key, route, tile, **raw):
    t = at.TuningTable(card="test card")
    t.put(kernel, key, route, tile)
    t.save(str(path))
    if raw:
        with open(path) as f:
            payload = json.load(f)
        payload.update(raw)
        with open(path, "w") as f:
            json.dump(payload, f)
    return str(path)


# -- keys and divisors: the reference's on the same inputs --------------------

@pytest.mark.parametrize("port,ref", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
    (torch.float16, np.float16), ("bfloat16", "bfloat16"),
    (np.float32, np.float32), ("float32", jnp.float32)])
@pytest.mark.parametrize("d_in,d_out,b,k", [(256, 128, 8, 77),
                                            (2048, 11008, 4, 307)])
def test_shape_key_equals_the_reference(port, ref, d_in, d_out, b, k):
    assert (at.shape_key(d_in, d_out, b, k, port)
            == jax_at.shape_key(d_in, d_out, b, k, ref))
    assert at.shape_key(256, 128, 8, 77, torch.float32) \
        == "di256-do128-b8-k77-float32"


@pytest.mark.parametrize("dim", [1, 7, 96, 130, 256, 2048, 11008])
def test_largest_divisor_equals_the_reference(dim):
    for want in (0, 1, 5, 8, 64, 100, 128, 256, 20000):
        assert at.largest_divisor(dim, want) \
            == jax_at.largest_divisor(dim, want)


# -- candidates, the rule and the search --------------------------------------

@pytest.mark.parametrize("kernel", at.KERNELS)
@pytest.mark.parametrize("route", ROUTES)
def test_candidates_are_fixed_largest_first_and_hold_the_rule(kernel, route):
    cands = at.candidate_blocks(kernel, route)
    assert cands == at.candidate_blocks(kernel, route)
    assert list(cands) == sorted(set(cands), reverse=True)
    for d_in in (8, 256, 2048, 11008):
        for d_out in (8, 256, 2048, 11008):
            for sms in (1, 132):
                assert at.default_blocks(kernel, route, d_in, d_out,
                                         sms=sms) in cands


def test_candidates_are_the_c_entry_points_tiles():
    assert at.candidate_blocks("fused_sampled_dw", "wgmma") == (128, 64)
    assert at.candidate_blocks("fused_sampled_dw", "fma") == (64,)
    assert at.candidate_blocks("sampled_matmul", "wgmma") == (256, 64)
    assert at.candidate_blocks("sampled_matmul", "wmma") == (128, 64)
    with pytest.raises(ValueError, match="no tiles"):
        at.candidate_blocks("row_norms", "wgmma")


@pytest.mark.parametrize("d_in,d_out,e", [(2048, 2048, 1), (2048, 256, 1),
                                          (2048, 11008, 1), (768, 768, 1),
                                          (1536, 8, 1), (1024, 512, 8)])
def test_default_blocks_is_todays_shape_rule(d_in, d_out, e):
    """fused_sampled_dw: 128 when E·⌈d_in/128⌉·⌈d_out/128⌉ reaches the SM
    count (the C entry point's pick_tile); sampled_matmul: smm_route's."""
    want = 128 if e * -(-d_in // 128) * -(-d_out // 128) >= 132 else 64
    assert at.default_blocks("fused_sampled_dw", "wgmma", d_in, d_out,
                             e=e) == want
    r = smm.smm_route(d_in, d_out, torch.bfloat16, True, 132)
    assert at.default_blocks("sampled_matmul", "wgmma", d_in, d_out) \
        == r.tile_m
    assert smm.choose_tile(torch.bfloat16, d_in, d_out, 132) \
        == at.default_blocks("sampled_matmul", "wmma", d_in, d_out)


@pytest.mark.parametrize("kernel,best", [("fused_sampled_dw", 64),
                                         ("sampled_matmul", 256)])
def test_autotune_same_key_same_tile(kernel, best):
    runs = [at.autotune(kernel, *SHAPE, measure=fake_measure(best))
            for _ in range(3)]
    assert all(r == runs[0] for r in runs)
    assert runs[0] == (best, 1.0)


@pytest.mark.parametrize("kernel", at.KERNELS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_autotune_tie_breaks_to_first_candidate(kernel, dtype):
    def flat(*args):
        return 1.0
    route = fused_sampling.dw_route(256, 256, at.torch_dtype(dtype))
    best, us = at.autotune(kernel, 256, 256, 8, 77, dtype, measure=flat)
    assert (best, us) == (at.candidate_blocks(kernel, route)[0], 1.0)
    assert at.fastest([(128, 3.0), (64, 3.0)]) == (128, 3.0)


@pytest.mark.parametrize("kernel", at.KERNELS)
def test_autotune_times_every_candidate_once_in_order(kernel):
    seen = []

    def measure(kernel, tile, *shape):
        seen.append(tile)
        return 1.0 if tile == 64 else 2.0
    assert at.autotune(kernel, *SHAPE, measure=measure) == (64, 1.0)
    assert seen == list(at.candidate_blocks(kernel, "wgmma"))


# -- the table ----------------------------------------------------------------

def test_table_roundtrip(tmp_path):
    t = at.TuningTable(card="NVIDIA H100 80GB HBM3, 700.00 W")
    key = at.shape_key(*SHAPE)
    t.put("fused_sampled_dw", key, "wgmma", 64, 12.5, {128: 20.0, 64: 12.5})
    t.put("sampled_matmul", key, "wgmma", 256, 9.25)
    p = t.save(str(tmp_path / "table.json"))
    t2 = at.TuningTable.load(p)
    assert t2.entries == t.entries and t2.card == t.card
    assert t2.entries["fused_sampled_dw"][key] == at.Entry(
        "wgmma", 64, 12.5, ((128, 20.0), (64, 12.5)))
    assert t2.lookup("sampled_matmul", key) == 256
    assert t2.lookup("sampled_matmul", key, "wmma") is None
    # resolve_blocks picks the entry up through table_path
    cfg = KernelConfig(table_path=p)
    assert at.resolve_blocks(cfg, "fused_sampled_dw", 256, 256, 8, 77,
                             torch.bfloat16) == 64
    assert at.resolve_blocks(cfg, "sampled_matmul", 256, 256, 8, 77,
                             "bfloat16") == 256


def test_refresh_table_merges_and_persists(tmp_path):
    p = str(tmp_path / "table.json")
    at.refresh_table([(64, 64, 2, 24, "bfloat16")], p,
                     measure=fake_measure(64), card="card A")
    t = at.TuningTable.load(p)
    key = at.shape_key(64, 64, 2, 24, "bfloat16")
    assert t.lookup("fused_sampled_dw", key) == 64
    assert t.lookup("sampled_matmul", key) == 64
    assert t.entries["sampled_matmul"][key].candidates_us == ((256, 2.0),
                                                              (64, 1.0))
    # merge keeps the old entry while adding a new shape
    at.refresh_table([(128, 64, 2, 24, "float32")], p,
                     measure=fake_measure(0), base=t, card="card A")
    t2 = at.TuningTable.load(p)
    key2 = at.shape_key(128, 64, 2, 24, "float32")
    assert t2.lookup("fused_sampled_dw", key) == 64
    assert t2.entries["fused_sampled_dw"][key2] == at.Entry(
        "fma", 64, 2.0, ((64, 2.0),))
    assert t2.card == "card A"


def test_packaged_table_is_the_ports_own_and_covers_the_sweep():
    assert os.path.dirname(at.PACKAGED_TABLE) == os.path.dirname(
        at.__file__)
    assert at.PACKAGED_TABLE != jax_at.PACKAGED_TABLE
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = at.TuningTable.load(at.PACKAGED_TABLE)
    with open(at.PACKAGED_TABLE) as f:
        raw = json.load(f)
    assert raw["version"] == at.TABLE_VERSION
    assert t.card.startswith("NVIDIA H100"), t.card
    for row in at.DEFAULT_SWEEP:
        route = fused_sampling.dw_route(row[0], row[1],
                                        at.torch_dtype(row[4]))
        for kernel in at.KERNELS:
            e = t.entries[kernel][at.shape_key(*row)]
            assert e.route == route
            # every entry is the fastest of the candidates its refresh timed
            assert [c for c, _ in e.candidates_us] == list(
                at.candidate_blocks(kernel, route))
            assert (e.tile, e.us) == at.fastest(e.candidates_us)


def test_missing_table_falls_back_silently(tmp_path):
    cfg = KernelConfig(table_path=str(tmp_path / "nope.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert at.resolve_blocks(cfg, "fused_sampled_dw", 256, 256, 8, 77,
                                 torch.bfloat16) == at.default_blocks(
            "fused_sampled_dw", "wgmma", 256, 256) == 64
        assert at.load_table(cfg.table_path).entries == {}


@pytest.mark.parametrize("case", ["json", "version", "tile", "route",
                                  "kernel", "key"])
def test_corrupt_table_warns_once_and_falls_back(tmp_path, case):
    p = tmp_path / "corrupt.json"
    key = at.shape_key(*SHAPE)
    if case == "json":
        p.write_text("{not json")
    elif case == "version":
        write_table(p, "fused_sampled_dw", key, "wgmma", 64, version=99)
    else:
        write_table(p, "fused_sampled_dw", key, "wgmma", 64)
        raw = json.loads(p.read_text())
        rec = raw["kernels"]["fused_sampled_dw"][key]
        if case == "tile":
            rec["tile"] = 256          # sampled_matmul's, not the dW's
        elif case == "route":
            rec["route"] = "mma"
        elif case == "kernel":
            raw["kernels"]["row_norms"] = raw["kernels"].pop(
                "fused_sampled_dw")
        else:
            raw["kernels"]["fused_sampled_dw"] = {"256x256": rec}
        p.write_text(json.dumps(raw))
    cfg = KernelConfig(table_path=str(p))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tiles = [at.resolve_blocks(cfg, "fused_sampled_dw", 256, 256, 8, 77,
                                   torch.bfloat16) for _ in range(2)]
    assert tiles == [64, 64]           # the shape rule's
    corrupt = [x for x in w if "corrupt" in str(x.message)]
    assert len(corrupt) == 1 and corrupt[0].category is RuntimeWarning


def test_cache_keys_on_the_path_and_clears(tmp_path):
    key = at.shape_key(*SHAPE)
    a = write_table(tmp_path / "a.json", "fused_sampled_dw", key, "wgmma",
                    64)
    b = write_table(tmp_path / "b.json", "fused_sampled_dw", key, "wgmma",
                    128)
    args = ("fused_sampled_dw", 256, 256, 8, 77, torch.bfloat16)
    assert at.load_table(a).lookup("fused_sampled_dw", key) == 64
    assert at.load_table(b).lookup("fused_sampled_dw", key) == 128
    assert at.resolve_blocks(KernelConfig(table_path=a), *args) == 64
    assert at.resolve_blocks(KernelConfig(table_path=b), *args) == 128
    write_table(a, "fused_sampled_dw", key, "wgmma", 128)
    # the cache holds the file as it was first read, until it is cleared
    assert at.resolve_blocks(KernelConfig(table_path=a), *args) == 64
    at.cache_clear()
    assert at.load_table(a).lookup("fused_sampled_dw", key) == 128
    assert at.resolve_blocks(KernelConfig(table_path=a), *args) == 128


# -- resolution priority ------------------------------------------------------

def test_pin_beats_table_beats_rule(tmp_path):
    key = at.shape_key(*SHAPE)
    p = write_table(tmp_path / "t.json", "fused_sampled_dw", key, "wgmma",
                    128)
    args = ("fused_sampled_dw", 256, 256, 8, 77, torch.bfloat16)
    assert at.resolve_blocks(KernelConfig(table_path=p), *args) == 128
    assert at.resolve_blocks(KernelConfig(table_path=p, dw_tile=64),
                             *args) == 64
    assert at.resolve_blocks(KernelConfig(table_path=p, dw_tile=128),
                             *args, tile=64) == 64
    # the entry was timed on wgmma: misaligned operands (wmma) miss it
    assert at.resolve_blocks(KernelConfig(table_path=p), *args,
                             aligned=False) == 64
    # another shape, or k, misses: the shape rule
    assert at.resolve_blocks(KernelConfig(table_path=p), "fused_sampled_dw",
                             256, 256, 8, 78, torch.bfloat16) == 64
    # a shape the rule gives 128 (every SM a 128 x 128 tile)
    assert at.resolve_blocks(KernelConfig(table_path=p), "fused_sampled_dw",
                             2048, 2048, 8, 77, torch.bfloat16) == 128
    # experts sharing the launch: the key has no expert count
    assert at.resolve_blocks(KernelConfig(table_path=p), *args, e=4) == 64
    # dw_tile pins the fused kernel only
    assert at.resolve_blocks(KernelConfig(table_path=p, dw_tile=128),
                             "sampled_matmul", 256, 256, 8, 77,
                             torch.bfloat16) == 64


def test_tile_sources_count_every_resolution(tmp_path):
    """``resolve_blocks.tile_sources`` counts each call by where its tile
    came from, a cached resolution included."""
    p = write_table(tmp_path / "t.json", "fused_sampled_dw",
                    at.shape_key(*SHAPE), "wgmma", 128)
    args = ("fused_sampled_dw", 256, 256, 8, 77, torch.bfloat16)
    before = dict(at.resolve_blocks.tile_sources)
    assert at.resolve_blocks(KernelConfig(table_path=p, dw_tile=64),
                             *args) == 64
    for _ in range(2):
        assert at.resolve_blocks(KernelConfig(table_path=p), *args) == 128
    for k in (78, 79, 80):
        assert at.resolve_blocks(KernelConfig(table_path=p),
                                 "fused_sampled_dw", 256, 256, 8, k,
                                 torch.bfloat16) == 64
    got = {s: n - before[s]
           for s, n in at.resolve_blocks.tile_sources.items()}
    assert got == {"pinned": 1, "table": 2, "rule": 3}
    # a wrapper handed its tile (the sampled linear's) resolves none
    h = torch.zeros((1, 4, 16), dtype=torch.bfloat16)
    z = torch.zeros((1, 8, 16), dtype=torch.bfloat16)
    i, s = torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4))
    before = dict(at.resolve_blocks.tile_sources)
    ops.sampled_matmul(h, z, i, s, tile=64)
    assert at.resolve_blocks.tile_sources == before
    ops.sampled_matmul(h, z, i, s)
    assert sum(at.resolve_blocks.tile_sources.values()) == sum(
        before.values()) + 1


def test_resolution_is_worked_out_once_per_shape(tmp_path, monkeypatch):
    """The backward of every sampled linear resolves its tile: after the
    first call the table is neither read nor looked into again."""
    p = write_table(tmp_path / "t.json", "fused_sampled_dw",
                    at.shape_key(*SHAPE), "wgmma", 128)
    args = ("fused_sampled_dw", 256, 256, 8, 77, torch.bfloat16)
    cfg = KernelConfig(table_path=p)
    assert at.resolve_blocks(cfg, *args) == 128
    calls = []
    real = at.TuningTable.lookup

    def lookup(self, *a):
        calls.append(a)
        return real(self, *a)
    monkeypatch.setattr(at.TuningTable, "lookup", lookup)
    monkeypatch.setattr(at.TuningTable, "load", None)
    assert [at.resolve_blocks(cfg, *args) for _ in range(3)] == [128] * 3
    assert calls == []


def test_kernel_config_carries_table_path(tmp_path):
    assert KernelConfig().table_path is None
    assert not hasattr(KernelConfig(), "autotune")
    kc = KernelConfig(dw_tile=64, table_path=str(tmp_path / "t.json"))
    spec = RunSpec(arch="qwen2.5-3b", kernel=kc)
    pol = cm.Policy(wtacrs=WTACRSConfig()).with_kernel(spec.kernel)
    assert pol.config_for("x/attn_q").kernel == kc


# -- the backward hands the kernel the table's tile ---------------------------

def _record_tiles(monkeypatch):
    tiles, real = [], ops.fused_sampled_dw

    def spy(hsub, *args, tile=None):
        tiles.append((hsub.ndim, tile))
        return real(hsub, *args, tile=tile)
    monkeypatch.setattr(ops, "fused_sampled_dw", spy)
    return tiles


@pytest.mark.parametrize("dtype,route,tile", [
    (torch.bfloat16, "wgmma", 128), (torch.bfloat16, "wgmma", 64),
    (torch.float32, "fma", 64)])
def test_linear_backward_hands_the_kernel_the_tables_tile(
        tmp_path, monkeypatch, dtype, route, tile):
    b, s, d_in, d_out = 3, 32, 32, 16
    cfg = WTACRSConfig(kind="det_topk", budget=0.3, min_rows=4)
    k = cfg.budget_rows(s)
    p = write_table(tmp_path / "t.json", "fused_sampled_dw",
                    at.shape_key(d_in, d_out, b, k, dtype), route, tile)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((b, s, d_in), generator=gen).to(dtype)
    w = torch.randn((d_in, d_out), generator=gen).to(dtype)
    dws = []
    rule = at.default_blocks("fused_sampled_dw", route, d_in, d_out)
    for kc, want in ((KernelConfig(table_path=p), tile),
                     (KernelConfig(table_path=p, dw_tile=64), 64),
                     (KernelConfig(table_path=p, dw_tile=128), 128),
                     (KernelConfig(table_path=str(tmp_path / "none.json")),
                      rule)):
        tiles = _record_tiles(monkeypatch)
        wl = w.clone().requires_grad_(True)
        z = linear.wtacrs_linear(h, wl, cfg=cfg.with_kernel(kc))
        dws.append(torch.autograd.grad(z.float().sum(), [wl])[0])
        assert tiles == [(3, want)]
    # the tile changes nothing the CPU computes
    for dw in dws[1:]:
        assert torch.equal(dw, dws[0])


def test_expert_axis_ignores_the_table(tmp_path, monkeypatch):
    e, c, d, f = 4, 16, 32, 24
    cfg = WTACRSConfig(kind="det_topk", budget=0.3, min_rows=4)
    k = cfg.budget_rows(c)
    key = at.shape_key(d, f, 1, k, torch.bfloat16)
    p = write_table(tmp_path / "t.json", "fused_sampled_dw", key, "wgmma",
                    128)
    gen = torch.Generator().manual_seed(1)
    h = torch.randn((e, c, d), generator=gen).to(torch.bfloat16)
    for kc, want in ((KernelConfig(table_path=p), 64),    # the rule's
                     (KernelConfig(table_path=p, dw_tile=128), 128)):
        tiles = _record_tiles(monkeypatch)
        w = torch.randn((e, d, f), generator=gen).to(
            torch.bfloat16).requires_grad_(True)
        (y,) = linear.expert_linear(h, (w,), key=None,
                                    cfg=cfg.with_kernel(kc))
        torch.autograd.grad(y.sum(), [w])
        assert tiles == [(4, want)]


# -- sampled_matmul at a pinned tile ------------------------------------------

@pytest.mark.parametrize("dtype,d_in,d_out,tile", [
    ("float32", 130, 70, 64),
    ("bfloat16", 136, 72, 256), ("bfloat16", 136, 72, 64),
    ("bfloat16", 130, 70, 128), ("bfloat16", 130, 70, 64)])
def test_pinned_sampled_matmul_equals_the_reference(dtype, d_in, d_out, tile):
    """Every candidate of the route the shape takes (wgmma at multiples of
    8, wmma otherwise, fma for f32): the padding the tile sets adds exact
    zeros, held against the reference's oracle at its tolerance."""
    b, k, n = 2, 20, 50
    rng = np.random.RandomState(7)
    hs = rng.randn(b, k, d_in).astype(np.float32)
    dz = rng.randn(b, n, d_out).astype(np.float32)
    idx = rng.randint(0, n, (b, k)).astype(np.int32)
    scale = rng.rand(b, k).astype(np.float32)
    tdt = at.torch_dtype(dtype)
    th, tz = torch.from_numpy(hs).to(tdt), torch.from_numpy(dz).to(tdt)
    ti, tsc = torch.from_numpy(idx), torch.from_numpy(scale)
    route = fused_sampling.dw_route(d_in, d_out, tdt)
    assert tile in at.candidate_blocks("sampled_matmul", route)
    got = ops.sampled_matmul(th, tz, ti, tsc, tile=tile)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_ref.sampled_matmul_batched_ref(
        jnp.asarray(hs, jdt), jnp.asarray(dz, jdt), jnp.asarray(idx),
        jnp.asarray(scale))
    # tests/test_kernels.py: f32 1e-4; bf16 rtol 3e-2, atol 3e-1 per sample
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else dict(rtol=3e-2, atol=3e-1 * b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # the plain version on the same operands, whatever the padding
    np.testing.assert_allclose(
        got.numpy(), fused_sampling.fused_sampled_dw_plain(
            th, tz, ti, tsc).numpy(), rtol=1e-6, atol=1e-6)
    r = smm.smm_route(d_in, d_out, tdt, True, 132, tile)
    assert (r.route, r.tile_m) == (route, tile)
    assert r.cluster == (2 if tile == 256 else 1)


def test_sampled_matmul_refuses_a_tile_its_route_does_not_take():
    h = torch.zeros((1, 4, 16), dtype=torch.bfloat16)
    z = torch.zeros((1, 8, 16), dtype=torch.bfloat16)
    i = torch.zeros((1, 4), dtype=torch.int32)
    s = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="wgmma route takes"):
        ops.sampled_matmul(h, z, i, s, tile=128)
    with pytest.raises(ValueError, match="fma route takes"):
        ops.sampled_matmul(h.float(), z.float(), i, s, tile=256)


def test_sampled_matmul_resolves_through_the_packaged_table():
    for row in at.DEFAULT_SWEEP:
        key = at.shape_key(*row)
        tile = at.resolve_blocks(None, "sampled_matmul", *row)
        assert tile == at.load_table().lookup("sampled_matmul", key)
        hsub = torch.zeros(row[2:4] + (row[0],), dtype=at.torch_dtype(row[4]))
        dz = torch.zeros((row[2], 1, row[1]), dtype=hsub.dtype)
        for kernel in at.KERNELS:
            assert at.tile_for(None, kernel, hsub, dz) == at.load_table(
                ).lookup(kernel, key)
        r = smm.smm_route(row[0], row[1], at.torch_dtype(row[4]), True,
                          132, tile)
        assert r.tile_m == tile


# -- the card the measure and the CLI need ------------------------------------

def test_cli_refresh_writes_table(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "refresh.json")
    monkeypatch.setattr(at, "_default_measure",
                        lambda device="cuda": fake_measure(64))
    monkeypatch.setattr(at, "card_line", lambda: "NVIDIA H100 test, 1 W")
    assert at.main(["--out", out, "--shapes",
                    "64,64,2,24,bfloat16;64,64,2,24,float32"]) == 0
    t = at.TuningTable.load(out)
    key = at.shape_key(64, 64, 2, 24, "bfloat16")
    assert t.lookup("fused_sampled_dw", key) == 64
    assert t.lookup("sampled_matmul", key) == 64
    assert t.card == "NVIDIA H100 test, 1 W"
    assert "wrote 4 entries" in capsys.readouterr().out
    # --merge replaces the bfloat16 rows and keeps the float32 ones
    monkeypatch.setattr(at, "_default_measure",
                        lambda device="cuda": fake_measure(256))
    assert at.main(["--out", out, "--shapes", "64,64,2,24,bfloat16",
                    "--merge"]) == 0
    t = at.TuningTable.load(out)
    assert t.lookup("sampled_matmul", key) == 256
    assert t.lookup("fused_sampled_dw",
                    at.shape_key(64, 64, 2, 24, "float32")) == 64
    assert "wrote 4 entries" in capsys.readouterr().out


def test_measure_and_cli_need_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tuner would time on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at._default_measure()
    with pytest.raises(ValueError, match="on a card"):
        at._default_measure("cpu")
    out = tmp_path / "t.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.main(["--out", str(out), "--shapes", "64,64,2,24,bfloat16"])
    assert not out.exists()
