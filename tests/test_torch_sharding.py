"""The port's meshes, sharding rules and abstract specs against the JAX
package's ``repro.launch.{mesh,sharding}``, ``registry.abstract_params`` /
``input_specs`` / ``decode_specs``, ``train_steps.abstract_train_state``
and ``optim.state_shardings``.

The rules only read axis sizes, so both packages run on stand-in meshes
of the production shapes (16x16, 2x16x16) and the reference test's 4x4:
the reference's ``NamedSharding``s on a jax ``AbstractMesh``, the port's
on ``launch.mesh.make_mesh``.  The port holds one tensor a layer where
the reference stacks the layers of a pattern position (or of an
encoder-decoder stack) on a leading axis whose logical name is
``layers``: ``convert.reference_leaf`` maps each port leaf to its
reference leaf, whose shape is the port's behind the stack's depth and
whose spec the port's behind a replicated layer dim.  Every comparison is
exact.  The port's own layouts (fused projections split by segment,
decode states split as the model code splits them) are held to the
reference's per-rank shapes and to their rule."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro import optim as jax_optim_lib
from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.launch import sharding as jax_sharding
from repro.launch import train_steps as jax_train_steps
from repro.models import registry as jax_registry
from repro_torch import convert
from repro_torch import optim as optim_lib
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, train_steps
from repro_torch.models import registry, ssm
from repro_torch.models.registry import get_config
from repro_torch.train import optim, znorm

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model"))}
DTYPES = {"float32": "float32", "bfloat16": "bfloat16", "int32": "int32"}


def _meshes(name):
    shape, axes = MESHES[name]
    return (mesh_lib.make_mesh(shape, axes),
            AbstractMesh(tuple(shape), tuple(axes)))


def _key(k):
    return str(k.key if hasattr(k, "key") else k.idx)


def _ref_flat(tree, is_leaf=None):
    """{"/"-joined path: leaf} of a reference tree."""
    return {"/".join(_key(k) for k in path): x for path, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _ref_specs(tree):
    return {path: tuple(s.spec) for path, s in _ref_flat(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding)).items()}


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _axes_leaf(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def test_arch_names_are_the_references():
    assert ARCH_NAMES == JAX_ARCH_NAMES


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_are_the_references_leaf_by_leaf(arch):
    cfg = get_config(arch)
    params, axes = registry.abstract_params(cfg)
    ref_params, ref_axes = jax_registry.abstract_params(jax_get_config(arch))
    ref_params = _ref_flat(ref_params)
    ref_axes = _ref_flat(ref_axes, is_leaf=_axes_leaf)
    seen = {}
    for path, p in optim.named_leaves(params):
        assert p.device.type == "meta"
        ref, index = convert.reference_leaf(cfg, path)
        want, want_axes = ref_params[ref], ref_axes[ref]
        if index is None:
            assert tuple(p.shape) == want.shape, path
            assert axes[path] == want_axes, path
        else:
            assert tuple(p.shape) == want.shape[1:], path
            assert 0 <= index < want.shape[0]
            assert want_axes[0] == "layers" and axes[path] == want_axes[1:]
        assert _dtype(p) == str(want.dtype), path
        seen.setdefault(ref, set()).add(index)
    # every reference leaf is covered, each stacked one layer by layer
    assert set(seen) == set(ref_params)
    for ref, idx in seen.items():
        if idx != {None}:
            assert idx == set(range(ref_params[ref].shape[0])), ref
    assert set(axes) == {path for path, _ in optim.named_leaves(params)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_are_the_references(arch, shape):
    got = registry.input_specs(get_config(arch), SHAPES[shape])
    want = jax_registry.input_specs(jax_get_config(arch), JAX_SHAPES[shape])
    g = optim.named_leaves(got)
    w = _ref_flat(want)
    assert [path for path, _ in g] == list(w)
    for path, x in g:
        assert x.device.type == "meta"
        assert tuple(x.shape) == w[path].shape, path
        assert _dtype(x) == str(w[path].dtype), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shardings_are_the_references(arch, mesh):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    port_mesh, ref_mesh = _meshes(mesh)
    rules = sharding.arch_rules(cfg, port_mesh)
    assert rules == jax_sharding.arch_rules(jcfg, ref_mesh)
    params, axes = registry.abstract_params(cfg)
    got = sharding.param_shardings(axes, params, port_mesh, rules=rules)
    ref_params, ref_axes = jax_registry.abstract_params(jcfg)
    want = _ref_specs(jax_sharding.param_shardings(
        ref_axes, ref_params, ref_mesh, rules=rules))
    for path, spec in got.items():
        ref, index = convert.reference_leaf(cfg, path)
        # the stacked layer dim is replicated ("layers" -> no mesh axis)
        assert (spec if index is None else (None,) + spec) == want[ref], \
            path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_rules_on_the_reference_tests_cases(mesh):
    port_mesh, ref_mesh = _meshes(mesh)
    cases = [(("ssm_inner", "ssm_inner"), (1536, 1536)),
             (("layers", "experts", "embed", "mlp"), (40, 16, 6144, 10752)),
             (("vocab", "embed"), (49155, 1024)),
             (("vocab", "embed"), (151936, 2048)),
             ((None, "kvheads"), (4, 256)), ((), ())]
    for axes, shape in cases:
        assert sharding._spec_for_axes(
            axes, shape, port_mesh, sharding.DEFAULT_RULES) == tuple(
            jax_sharding._spec_for_axes(axes, shape, ref_mesh,
                                        jax_sharding.DEFAULT_RULES))
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_shardings_are_the_references(arch, mesh):
    port_mesh, ref_mesh = _meshes(mesh)
    for shape in ("train_4k", "prefill_32k"):
        for batch in (SHAPES[shape].global_batch, 1, 48):
            cell = type(SHAPES[shape])(shape, SHAPES[shape].seq_len // 8,
                                       batch, SHAPES[shape].kind)
            got = sharding.batch_shardings(
                registry.input_specs(get_config(arch), cell), port_mesh)
            want = _ref_specs(jax_sharding.batch_shardings(
                jax_registry.input_specs(jax_get_config(arch), cell),
                ref_mesh))
            assert got == want, (shape, batch)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_state_shardings_are_the_references(arch, mesh):
    port_mesh, ref_mesh = _meshes(mesh)
    for shape in ("decode_32k", "long_500k"):
        sh = SHAPES[shape]
        _, _, states = registry.decode_specs(get_config(arch),
                                             sh.global_batch, sh.seq_len)
        _, _, ref_states = jax_registry.decode_specs(
            jax_get_config(arch), sh.global_batch, sh.seq_len)
        g, w = optim.named_leaves(states), _ref_flat(ref_states)
        assert [path for path, _ in g] == list(w)
        for path, x in g:
            assert x.device.type == "meta"
            assert (tuple(x.shape), _dtype(x)) == \
                (w[path].shape, str(w[path].dtype)), path
        got = sharding.decode_state_shardings(states, port_mesh,
                                              sh.global_batch)
        want = _ref_specs(jax_sharding.decode_state_shardings(
            ref_states, ref_mesh, sh.global_batch))
        assert got == want, shape


def _bench_memory_specs(pkg):
    """The reference's benchmark specs (``benchmarks/bench_memory.py``)."""
    return {
        "dense_adamw": pkg.OptimSpec(),
        "factored_came": pkg.OptimSpec.of(
            dict(pattern="*", layout="factored", momentum=True)),
        "factored": pkg.OptimSpec.of(
            dict(pattern="*", layout="factored", momentum=False)),
        "lowrank@8": pkg.OptimSpec.of(
            dict(pattern="*", layout="lowrank", rank=8)),
        "mixed": pkg.OptimSpec.of(
            dict(pattern="unit/*", layout="lowrank", rank=8),
            dict(pattern="embed*", layout="factored", momentum=False)),
    }


SPECS = [None] + list(_bench_memory_specs(optim_lib))


def _abstract_states(arch, spec):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    tags = znorm.collect_linear_tags(cfg)
    kw = dict(znorm_tags=tags, n_dataset=64, budget_stats=True)
    opt = (None, None) if spec is None else (
        _bench_memory_specs(optim_lib)[spec],
        _bench_memory_specs(jax_optim_lib)[spec])
    state, axes = train_steps.abstract_train_state(cfg, opt=opt[0], **kw)
    ref, ref_axes = jax_train_steps.abstract_train_state(jcfg, opt=opt[1],
                                                         **kw)
    return cfg, jcfg, (state, axes), (ref, ref_axes)


@pytest.mark.parametrize("spec", SPECS, ids=["adamw"] + SPECS[1:])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b",
                                  "whisper-base", "granite-moe-1b-a400m"])
def test_abstract_train_state_is_the_references(arch, spec):
    cfg, _, (state, _), (ref, _) = _abstract_states(arch, spec)
    assert set(state) == set(ref) - {"base_key"} | {"base_seed"}
    assert (state["step"], type(state["base_seed"])) == (0, int)
    for name in ("znorm", "budget_stats"):
        assert list(state[name]) == list(ref[name])
        for t, x in state[name].items():
            assert x.device.type == "meta"
            assert (tuple(x.shape), _dtype(x)) == \
                (ref[name][t].shape, str(ref[name][t].dtype))
    if spec is None:
        # dense AdamW: m and v like the parameters, f32
        refs = _ref_flat(ref["opt"].m)
        for path, x in optim.named_leaves(state["opt"].m):
            want, index = refs[convert.reference_leaf(cfg, path)[0]], \
                convert.reference_leaf(cfg, path)[1]
            assert tuple(x.shape) == (want.shape if index is None
                                      else want.shape[1:]), path
            assert x.device.type == "meta" and _dtype(x) == "float32"
        return
    # the layouts keep the reference's stacked slots: the same keys and
    # shapes, slot by slot
    assert state["opt"]["count"] == 0
    assert set(state["opt"]["leaves"]) == set(ref["opt"]["leaves"])
    for leaf, slots in state["opt"]["leaves"].items():
        want = ref["opt"]["leaves"][leaf]
        assert set(slots) == set(want), leaf
        for slot, x in slots.items():
            assert x.device.type == "meta"
            assert (tuple(x.shape), _dtype(x)) == \
                (want[slot].shape, str(want[slot].dtype)), (leaf, slot)


@pytest.mark.parametrize("spec", SPECS, ids=["adamw"] + SPECS[1:])
@pytest.mark.parametrize("mesh", ["16x16", "4x4"])
def test_train_state_shardings_are_the_references(mesh, spec):
    arch = "qwen2.5-3b"
    port_mesh, ref_mesh = _meshes(mesh)
    cfg, jcfg, (state, axes), (ref, ref_axes) = _abstract_states(arch, spec)
    got = train_steps.train_state_shardings(cfg, state, axes, port_mesh)
    want = jax_train_steps.train_state_shardings(jcfg, ref, ref_axes,
                                                 ref_mesh)
    for name in ("step", "base_seed"):
        assert got[name] == ()
    assert tuple(want["step"].spec) == () == tuple(want["base_key"].spec)
    for name in ("znorm", "budget_stats"):
        assert got[name] == {t: () for t in state[name]}
        assert {t: tuple(s.spec) for t, s in want[name].items()} == \
            got[name]
    p_want = _ref_specs(want["params"])
    if spec is None:
        assert got["opt"].count == () and got["opt"].m == got["params"]
        assert got["opt"].v == got["params"]
        for path, s in got["params"].items():
            ref_leaf, index = convert.reference_leaf(cfg, path)
            assert (s if index is None else (None,) + s) == p_want[ref_leaf]
        return
    # a slot shaped like its stacked parameter takes its spec, any other
    # is replicated
    assert got["opt"]["count"] == ()
    want_opt = {leaf: {slot: tuple(s.spec) for slot, s in slots.items()}
                for leaf, slots in want["opt"]["leaves"].items()}
    assert got["opt"]["leaves"] == want_opt


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_shape_and_batch(mesh):
    port_mesh, _ = _meshes(mesh)
    dsize = mesh_lib.mesh_size(port_mesh, mesh_lib.data_axes(port_mesh))
    batch = {"tokens": np.arange(dsize * 6 * 5).reshape(dsize * 6, 5),
             "positions3": np.zeros((3, dsize * 6, 5), np.int32),
             "odd": np.zeros((dsize * 6 + 1, 2))}
    specs = sharding.batch_shardings(batch, port_mesh)
    assert sharding.shard_shape((dsize * 6, 5), specs["tokens"],
                                port_mesh) == (6, 5)
    assert sharding.shard_shape((3, dsize * 6, 5), specs["positions3"],
                                port_mesh) == (3, 6, 5)
    assert specs["odd"] == ()
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_shape((7, 5), specs["tokens"], port_mesh)
    # an abstract mesh has no rank of its own: index 0, the first slice
    part = sharding.shard_batch(batch, port_mesh)
    np.testing.assert_array_equal(part["tokens"], batch["tokens"][:6])
    assert part["positions3"].shape == (3, 6, 5)
    assert part["odd"] is batch["odd"]


# ---------------------------------------------------------------------------
# the port's own layouts: fused projections by segment, decode states as
# the model code splits them
# ---------------------------------------------------------------------------

FUSED = {"zamba2-2.7b": ("mamba/in_proj", "mamba/conv_w", "mamba/conv_b"),
         "xlstm-125m": ("mlstm/up",)}


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("arch", list(FUSED))
def test_fused_projections_split_segment_by_segment(arch, m):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    port_mesh = mesh_lib.make_mesh((1, m), ("data", "model"))
    ref_mesh = AbstractMesh((1, m), ("data", "model"))
    params, axes = registry.abstract_params(cfg)
    rules = sharding.arch_rules(cfg, port_mesh)
    got = sharding.param_shardings(axes, params, port_mesh, rules=rules)
    ref_params, ref_axes = jax_registry.abstract_params(jcfg)
    want = jax_sharding.param_shardings(ref_axes, ref_params, ref_mesh,
                                        rules=rules)
    want_flat = _ref_flat(want, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    ref_flat = _ref_flat(ref_params)
    seen = 0
    for path, p in optim.named_leaves(params):
        if not path.endswith(FUSED[arch]):
            continue
        seen += 1
        spec = got[path]
        ref, index = convert.reference_leaf(cfg, path)
        # the reference's spec and per-rank shape, the segments carried
        assert isinstance(spec, sharding.Segmented), path
        assert (None,) + spec == tuple(want_flat[ref].spec)
        shape = sharding.shard_shape(tuple(p.shape), spec, port_mesh)
        assert (ref_flat[ref].shape[0],) + shape == \
            want_flat[ref].shard_shape(ref_flat[ref].shape)
        widths, group = ssm.segments(cfg, *path.split("/")[-2:])
        assert spec.widths == widths and sum(widths) == p.shape[-1]
        assert shape[-1] == sum(w // m for w in widths)
        if not path.startswith("layers/0/"):
            continue
        # rank r holds the r-th 1/m of every segment, in order; the ranks'
        # shards gathered back are the leaf
        whole = torch.arange(p.numel(), dtype=torch.float32).reshape(
            p.shape)
        shards = []
        for r in range(m):
            mesh_r = mesh_lib.meta_mesh(port_mesh, {"data": 0, "model": r})
            got_r = sharding._rank_slice(whole, spec, mesh_r)
            want_r = torch.cat([seg.narrow(-1, r * (w // m), w // m)
                                for seg, w in zip(whole.split(widths, -1),
                                                  widths)], -1)
            assert torch.equal(got_r, want_r), (path, r)
            shards.append(got_r)
        assert torch.equal(sharding._unsegment(torch.cat(shards, -1), spec,
                                               m), whole)
    block = FUSED[arch][0].split("/")[0]
    assert seen == len(FUSED[arch]) * cfg.n_layers * cfg.pattern.count(
        block) // len(cfg.pattern)


def test_segments_that_do_not_divide_split_contiguously():
    cfg = dataclasses.replace(get_config("zamba2-2.7b", reduced=True),
                              ssm_state=7)
    port_mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    params, axes = registry.abstract_params(cfg)
    got = sharding.param_shardings(axes, params, port_mesh)
    spec = got["layers/0/mamba/in_proj"]
    # 7 does not divide 2: the reference's contiguous split (Mamba2 then
    # takes the gathered path)
    assert spec == (None, "model") and not isinstance(
        spec, sharding.Segmented)


DECODE_CASES = {"zamba2-2.7b": {}, "xlstm-125m": {},
                "xlstm-125m/h1": {"n_heads": 1, "n_kv_heads": 1},
                "whisper-base": {}}


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_state_specs_split_recurrent_states_by_heads(case, m):
    cfg = dataclasses.replace(get_config(case.split("/")[0]),
                              **DECODE_CASES[case])
    mesh = mesh_lib.make_mesh((2, m), ("data", "model"))
    _, _, states = registry.decode_specs(cfg, 4, 1024)
    specs = sharding.decode_state_specs(cfg, states, mesh, 4)
    heuristic = sharding.decode_state_shardings(states, mesh, 4)
    leaves = dict(optim.named_leaves(states))
    assert set(specs) == set(leaves)
    for path, spec in specs.items():
        block, _, name = path.partition("/")
        x = leaves[path]
        if cfg.is_encdec:
            # self-attention caches on their sequence; cross caches by
            # heads where the kv heads divide, else whole
            want = heuristic[path]
            if block in ("xk", "xv"):
                want = (None, "data", None,
                        "model" if cfg.n_kv_heads % m == 0 else None, None)
            assert spec == want, path
            continue
        btype = cfg.pattern[int(block)]
        if btype not in ssm.RECURRENT:
            assert spec == heuristic[path], path    # a KV cache
            continue
        split = ssm.splits_heads(cfg, btype, m)
        dim = 3 if name == "conv" else 2
        want = [None] * x.ndim
        want[1] = "data"
        if split:
            want[dim] = "model"
        assert spec == tuple(want), (path, spec)
        assert isinstance(spec, sharding.Segmented) == (split and
                                                        name == "conv")
        local = sharding.shard_shape(tuple(x.shape), spec, mesh)
        if split and name != "conv":
            assert local[2] == x.shape[2] // m     # this rank's heads
    # xlstm-125m's 4 heads do not divide 16: every rank holds every head
    if case == "xlstm-125m":
        assert ssm.splits_heads(cfg, "mlstm", m) == (m == 2)
    if case == "xlstm-125m/h1":
        assert not ssm.splits_heads(cfg, "slstm", m)
