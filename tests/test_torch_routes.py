"""The kernel routes of the port and the C interface they go through,
checked without a card or a compiler: ``flash_route``, ``dw_route``,
``smm_route`` and ``gather_route`` map every shape to exactly one route
(the main paths' shapes to ``wgmma``, or ``bulk`` for the gather),
the route codes match the C enums, and every ``extern "C"`` entry point in
``csrc/*.cu`` takes as many parameters as its ``_build._SIGNATURES`` entry
declares (a ctypes arity mismatch is silent until the card runs it)."""
import re

import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import fused_sampling
from repro_torch.kernels import gather_scale as gather_mod
from repro_torch.kernels import sampled_matmul as smm

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
HALF = (torch.bfloat16, torch.float16)


def _extern_c_entries():
    """{name: (source file, parameter count)} of every extern "C" entry."""
    out = {}
    pattern = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, params in pattern.findall(path.read_text()):
            out[name] = (path.name, len([p for p in params.split(",")
                                         if p.strip()]))
    return out


def test_every_entry_point_is_declared_and_every_declaration_exists():
    assert set(_extern_c_entries()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_entry_point_arity_matches_its_signature(name):
    source, n_params = _extern_c_entries()[name]
    assert n_params == len(_build._SIGNATURES[name]), (
        f"{source}: {name} takes {n_params} parameters, _build declares "
        f"{len(_build._SIGNATURES[name])}")


@pytest.mark.parametrize("module,source", [
    (flash_mod, "flash_attention_fwd.cu"),
    (fused_sampling, "fused_sampled_dw.cu"),
    (smm, "sampled_matmul.cu"),
    (gather_mod, "gather_scale.cu")])
def test_route_codes_match_the_c_enum(module, source):
    text = (_build.CSRC / source).read_text()
    enum = re.search(r"enum Route : int \{([^}]*)\}", text).group(1)
    codes = {m.group(1).lower(): int(m.group(2))
             for m in re.finditer(r"kRoute(\w+)\s*=\s*(\d+)", enum)}
    assert codes == {route: i for i, route in enumerate(module.ROUTES)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_flash_route_maps_every_head_dim_to_one_route(dtype, aligned):
    for dh in range(8, flash_mod.MAX_HEAD_DIM + 1, 8):
        route = flash_mod.flash_route(dh, dtype, aligned)
        assert route in flash_mod.ROUTES
        if dtype == torch.float32:
            assert route == "fma"
        elif aligned and dh <= 128:
            assert route == "wgmma"
        else:
            assert route == "mma"


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("dh", [64, 128, 80])  # minicpm-2b, qwen2.5-3b, zamba2
def test_flash_main_shapes_take_the_wgmma_route(dh, dtype):
    assert flash_mod.flash_route(dh, dtype) == "wgmma"


def _c_flash_wgmma_head_dims():
    """The head dims the C entry point lets through to a wgmma launch: its
    own check of dh, then ``dispatch_wgmma``'s clauses (each instance's
    Q K^T k-steps and tile capacity hold every dh it takes)."""
    text = (_build.CSRC / "flash_attention_fwd.cu").read_text()
    lo, hi, step = map(int, re.search(
        r"dh < (\d+) \|\|\s*dh > (\d+) \|\| dh % (\d+) != 0", text).groups())
    body = re.search(r"int dispatch_wgmma\(const Args& a\) \{\n(.*?)\n\}",
                     text, re.S).group(1).splitlines()
    assert re.fullmatch(r"\s*if \(!\(aligned16\(a\.q\) && "
                        r"aligned16\(a\.k\) && aligned16\(a\.v\)\)\) "
                        r"return -2;", body[0])
    assert body[-1].strip() == "return -2;"
    clauses = [re.fullmatch(r"\s*if \(a\.dh <= (\d+)\) return "
                            r"launch_wgmma<T, (\d+)>\(a\);", ln)
               for ln in body[1:-1]]
    assert clauses and all(clauses), body
    bounds = [tuple(map(int, m.groups())) for m in clauses]
    cap = re.search(r"kCap = kSteps > (\d+) \? (\d+) : (\d+);", text)
    split, wide, narrow = map(int, cap.groups())
    for bound, steps in bounds:
        # Q K^T's k16 steps span the clause's head dims, inside a capacity
        # of whole 64-column atoms
        capacity = wide if steps > split else narrow
        assert bound <= 16 * steps <= capacity and capacity % 64 == 0, (
            bound, steps, capacity)
    return {dh for dh in range(lo, hi + 1, step)
            if any(dh <= bound for bound, _ in bounds)}


@pytest.mark.parametrize("dtype", HALF)
def test_c_dispatch_takes_exactly_the_wgmma_head_dims(dtype):
    """``dispatch_wgmma`` (csrc/flash_attention_fwd.cu) accepts exactly the
    aligned head dims ``flash_route`` sends to ``wgmma``: one it refused
    would raise at launch, one it took beyond them would never be asked."""
    want = {dh for dh in range(8, flash_mod.MAX_HEAD_DIM + 1, 8)
            if flash_mod.flash_route(dh, dtype, True) == "wgmma"}
    assert _c_flash_wgmma_head_dims() == want
    assert max(want) == flash_mod.WGMMA_MAX_HEAD_DIM


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_dw_route_maps_every_width_to_one_route(dtype, aligned):
    for d_in in (1, 7, 8, 130, 136, 2048):
        for d_out in (1, 24, 70, 256, 11008):
            route = fused_sampling.dw_route(d_in, d_out, dtype, aligned)
            assert route in fused_sampling.ROUTES
            if dtype == torch.float32:
                assert route == "fma"
            elif aligned and d_in % 8 == 0 and d_out % 8 == 0:
                assert route == "wgmma"
            else:
                assert route == "wmma"


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d_in,d_out", [(2048, 2048), (2048, 256),
                                        (2048, 11008), (11008, 2048)])
def test_dw_main_shapes_take_the_wgmma_route(d_in, d_out, dtype):
    assert fused_sampling.dw_route(d_in, d_out, dtype) == "wgmma"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sms", [1, 132])
def test_smm_route_maps_every_width_to_one_configuration(dtype, aligned,
                                                         sms):
    for d_in in (1, 7, 8, 130, 136, 2048, 2056, 11008):
        for d_out in (1, 24, 70, 256, 384, 1160, 11008):
            r = smm.smm_route(d_in, d_out, dtype, aligned, sms)
            assert r.route in smm.ROUTES
            if dtype == torch.float32:
                assert r == ("fma", smm.F32_TILE, smm.F32_TILE, 1)
            elif aligned and d_in % 8 == 0 and d_out % 8 == 0:
                # the C entry point knows exactly these two wgmma tiles
                assert r in (("wgmma", 256, 128, 2), ("wgmma", 64, 64, 1))
            else:
                tile = smm.choose_tile(dtype, d_in, d_out, sms)
                assert r == ("wmma", tile, tile, 1)


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d_in,d_out,tile", [
    (2048, 2048, 256), (2048, 11008, 256), (11008, 2048, 256),
    (2048, 256, 64)])   # the narrow k/v projection: no cluster
def test_smm_main_shapes_take_the_wgmma_route(d_in, d_out, tile, dtype):
    r = smm.smm_route(d_in, d_out, dtype, True, 132)
    assert (r.route, r.tile_m) == ("wgmma", tile)
    assert r.cluster == (2 if tile == 256 else 1)
    # 256 x 128 tiles in clusters of two only while half the SMs get a block
    blocks = 2 * -(-d_in // 256) * -(-d_out // 256)
    assert (tile == 256) == (2 * blocks >= 132)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_route_maps_every_width_to_one_route(dtype, aligned):
    item = torch.empty((), dtype=dtype).element_size()
    for d in (1, 2, 3, 4, 5, 7, 8, 12, 16, 130, 1032, 4100, 24576, 24577):
        route = gather_mod.gather_route(d, dtype, aligned)
        assert route in gather_mod.ROUTES
        if aligned and d * item % 16 == 0:
            assert route == "bulk"
        else:
            assert route == "warp"


@pytest.mark.parametrize("d", [512, 1024, 2048, 6144, 10752, 11008, 24576])
def test_gather_main_shapes_take_the_bulk_route(d):
    # granite's d_ff / d_model, qwen2.5-3b's, dbrx's and nemotron-4-15b's
    # widths in the path's bf16, and the f32 train rows
    assert gather_mod.gather_route(d, torch.bfloat16) == "bulk"
    assert gather_mod.gather_route(d, torch.float32) == "bulk"


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 1030),
                                     (torch.float16, 4099),
                                     (torch.float32, 4101),
                                     (torch.bfloat16, 3)])
def test_gather_ragged_widths_take_the_warp_route(dtype, d):
    assert gather_mod.gather_route(d, dtype) == "warp"


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_misaligned_views_take_the_warp_route(dtype):
    flat = torch.zeros(8 * 64 + 8, dtype=dtype)
    view = flat[1:1 + 8 * 64].view(8, 64)
    assert not _build.aligned16(view)
    assert gather_mod.gather_route(64, dtype,
                                   _build.aligned16(view)) == "warp"
    assert gather_mod.gather_route(64, dtype,
                                   _build.aligned16(flat[:64])) == "bulk"


def test_alignment_is_read_from_the_data_pointer():
    flat = torch.zeros(64, dtype=torch.bfloat16)
    assert _build.aligned16(flat[:32], flat[8:40])
    assert not _build.aligned16(flat[:32], flat[1:33])


@pytest.mark.parametrize("name,module", [
    ("flash_attention_fwd", flash_mod), ("fused_sampled_dw", fused_sampling),
    ("sampled_matmul", smm), ("gather_scale", gather_mod)])
def test_launches_by_route_names_every_route_and_cpu_calls_count_none(
        name, module):
    fn = getattr(ops, name)
    assert set(fn.launches_by_route) == set(module.ROUTES)
    before = dict(fn.launches_by_route)
    launches = fn.launches
    if name == "gather_scale":
        x = torch.randn(2, 5, 16, dtype=torch.bfloat16)
        idx = torch.zeros(2, 3, dtype=torch.int32)
        fn(x, idx, torch.ones(2, 3))
        fn(x[0], idx[0], torch.ones(3))
    elif name == "flash_attention_fwd":
        q = torch.randn(2, 5, 64, dtype=torch.bfloat16)
        fn(q, q[:1].clone(), q[:1].clone(), group=2)
    else:
        h = torch.randn(1, 3, 16, dtype=torch.bfloat16)
        z = torch.randn(1, 4, 8, dtype=torch.bfloat16)
        fn(h, z, torch.zeros(1, 3, dtype=torch.int32), torch.ones(1, 3))
    assert fn.launches_by_route == before
    assert fn.launches == launches
