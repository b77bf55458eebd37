"""repro_torch.analysis' JL and PK families: each fixture fires its rule
exactly once and its clean twin stays silent (the engine's edges — dict
carriage, tuple unpack, argument flow, re-binding, ``partial``,
cross-module import, a class ``__call__`` step, ``autograd.Function``
and ``checkpoint`` recompute scopes, a helper in an ``#include``d
``.cuh``, a macro-built PTX string — among them); the step scopes equal
the reference's traced scopes on builder-only sources, and on the port's
``launch/`` they hold every inner def the reference's heuristic finds
and ``ScheduledStepFn.__call__``; ``int(state["step"])`` and an
explicit ``.cpu()`` stay silent; the C evaluator reckons launch bounds,
struct constants, ``sizeof`` and static shared bytes as by hand; the
registry's ids and severities are the reference's.  Sources are written
to ``tmp_path``; nothing is imported from them, built or launched."""
import os
import textwrap

import pytest

import repro.analysis as ref_analysis
from repro.analysis import astutil as ref_astutil
from repro.analysis import dataflow as ref_dataflow
from repro.analysis import jax_lints as ref_jax_lints
from repro.analysis.findings import RULES as REF_RULES
from repro_torch.analysis import (RULES, analyze_paths, astutil, csrc,
                                  dataflow, kernel_contracts, main)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAUNCH = os.path.join(ROOT, "src", "repro_torch", "launch")
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")


def _write(tmp_path, files):
    paths = []
    for name, src in files.items():
        p = tmp_path / name
        p.write_text(textwrap.dedent(src))
        paths.append(str(p))
    return paths


# ---------------------------------------------------------------------------
# fixtures: (name, rule, {file: source}, {file: (old, new)} for the twin)
# ---------------------------------------------------------------------------

STEP_ITEM = """
import torch

def make_step(cfg):
    def step(state, batch):
        loss = torch.sum(batch)
        return state, loss.item()
    return step
"""

DICT_CARRIAGE = """
import torch

def make_steps(cfg):
    def step(state, batch):
        norm = torch.linalg.vector_norm(batch)
        return float(norm)
    return {"step": step, "name": cfg}
"""

TUPLE_UNPACK = """
import torch

def pair(cfg):
    def step(state, batch):
        x = torch.mean(batch)
        return bool(x)
    def init(n):
        return n
    return step, init

def make_step(cfg):
    step_fn, init_fn = pair(cfg)
    return step_fn
"""

ARG_FLOW = """
import torch

def _read(t, n):
    return t.tolist()[:n]

def make_step(cfg):
    def step(state, batch):
        z = torch.exp(batch)
        return _read(z, 3)
    return step
"""

REBIND = """
import torch

def make_step(cfg):
    def step(state, batch):
        s = torch.sum(batch)
        if s > 0:
            return state
        return batch
    fn = step
    chosen = fn
    return chosen
"""

PARTIAL = """
import functools

import torch

def _apply(cfg, state, batch):
    y = torch.tanh(batch)
    return int(y)

def make_step(cfg):
    return functools.partial(_apply, cfg)
"""

IMPORTED_IMPL = """
import torch

def step_impl(state, batch):
    total = torch.cumsum(batch, 0)
    return total.numpy()
"""

IMPORTED_BUILDER = """
from impl import step_impl

def make_step(cfg):
    return step_impl
"""

CLASS_STEP = """
import torch

class StepFn:
    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, state, batch):
        step = int(state["step"])
        stats = torch.stack([state["a"], state["b"]])
        host = stats.cpu().numpy()
        loss = torch.sum(batch) * step
        return float(loss), host

def make_scheduled_step(cfg):
    return StepFn(cfg)
"""

NOTE_FALLBACK = """
import torch

def make_registered_step(cfg, registry):
    def step(state, batch):
        loss = torch.sum(state * batch)
        return state, int(loss)
    registry.step = step
    return registry
"""

TICK = """
import torch

def make_decode(cfg):
    def decode(params, tokens):
        return torch.argmax(params @ tokens, dim=-1)
    return decode

class Server:
    def __init__(self, cfg):
        self._decode = make_decode(cfg)

    def tick(self):
        out = self._decode(self.params, self.tokens)
        return int(out[0])
"""

CHECKPOINTED = """
import torch
from torch.utils.checkpoint import checkpoint

def block(x, weights):
    scales = []
    def run(h):
        return h * scales[0]
    scales.append(2.0)
    return checkpoint(run, x, use_reentrant=False)
"""

AUTOGRAD_FN = """
import torch

class _Remat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x):
        ctx.run = run
        return run(x)

    @staticmethod
    def backward(ctx, g):
        return None, g

def layer(x, w):
    history = []
    def run(h):
        history.append(h.shape)
        return h @ w
    return _Remat.apply(run, x)
"""

SEED_REUSE = """
import torch
from repro_torch.core.seeds import fold_seed

def plans(seed, device):
    key = fold_seed(seed, 1)
    g1 = torch.Generator(device=device)
    g1.manual_seed(key)
    g2 = torch.Generator(device=device)
    g2.manual_seed(int(key))
    return g1, g2
"""

BRANCH = """
import torch

def make_step(cfg):
    def step(state, batch):
        peak = torch.amax(batch)
        if peak.shape[0] > 1:
            state = state + 1
        while torch.any(batch > peak):
            batch = batch * 0.5
        return state, batch
    return step
"""

HASH_SEED = """
import zlib
from repro_torch.core.seeds import fold_seed

def tag_seed(seed, tag):
    return fold_seed(seed, hash(tag))
"""

ESCAPE = """
import torch

LOSSES = []

def make_step(cfg):
    def step(state, batch):
        loss = torch.sum(batch * state)
        LOSSES.append(loss)
        return loss
    return step
"""

SIGNATURES = """
import ctypes

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_scale": (_P, _P, _I, _I, _P),
}
"""

ENTRY = """
#include <cuda_runtime.h>

__global__ void __launch_bounds__(128) scale_kernel(float* y, int n) {
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i >= n) return;
  y[i] = 2.f * y[i];
}

extern "C" int repro_scale(const void* x, void* y, int n, void* stream) {
  scale_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (float*)y, n);
  return (int)cudaGetLastError();
}
"""

BOUNDS = """
template <int kThreads>
__global__ void __launch_bounds__(kThreads) fill_kernel(float* y) {
  y[threadIdx.x] = 0.f;
}

int launch(float* y, cudaStream_t s) {
  fill_kernel<128><<<1, 256, 0, s>>>(y);
  return 0;
}
"""

FLOOR_GRID = """
__global__ void __launch_bounds__(64) tile_kernel(float* y, int n) {
  y[blockIdx.x * 64 + threadIdx.x] = 1.f;
}

int launch(float* y, int n, cudaStream_t s) {
  dim3 grid(n / 64);
  tile_kernel<<<grid, 64, 0, s>>>(y, n);
  return 0;
}
"""

SMEM = """
constexpr int kRows = 512;

template <typename T>
__global__ void __launch_bounds__(128) stage_kernel(const T* x, T* y) {
  __shared__ __align__(16) T tile[kRows * 128];
  tile[threadIdx.x] = x[threadIdx.x];
  y[threadIdx.x] = tile[threadIdx.x];
}

template <typename T>
int launch(const T* x, T* y, cudaStream_t s) {
  stage_kernel<T><<<1, 128, 0, s>>>(x, y);
  return 0;
}

int entry(const float* x, float* y, cudaStream_t s) {
  return launch<float>(x, y, s);
}
"""

MMA_HEADER = """
#pragma once
#include <cuda_fp16.h>

#define DEFINE_MMA(TY, CT)                                        \\
  __device__ void mma64(CT, float (&d)[32], unsigned long long a, \\
                        unsigned long long b) {                   \\
    asm volatile("{\\n" "wgmma.mma_async.sync.aligned.m64n64k16." TY \\
                 "." TY "." TY " {%0}, %1, %2, 1, 1, 1, 1, 1;\\n}\\n"  \\
                 : "+f"(d[0]) : "l"(a), "l"(b));                  \\
  }

DEFINE_MMA("f16", __half)
#undef DEFINE_MMA
"""

MMA_KERNEL = """
#include "mma.cuh"

__global__ void __launch_bounds__(128) gemm_kernel(float* out) {
  float d[32];
  mma64(__half(), d, 0ull, 0ull);
  out[threadIdx.x] = d[0];
}
"""

PIPE_HEADER = """
#pragma once
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\\n" ::"n"(N) : "memory");
}
"""

PIPE_KERNEL = """
#include "pipe.cuh"

__global__ void __launch_bounds__(128) store_kernel(float* out) {
  out[threadIdx.x] = 0.f;
  bulk_commit();
}
"""

CEIL_GRID = """
inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

__global__ void __launch_bounds__(256) copy_kernel(const float* x,
                                                   float* y, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  y[i] = x[i];
}

int launch(const float* x, float* y, int n, cudaStream_t s) {
  copy_kernel<<<cdiv(n, 256), 256, 0, s>>>(x, y, n);
  return 0;
}
"""

MASK_TAIL = """
__global__ void __launch_bounds__(256) scale_kernel(const float* x,
                                                    float* y, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  y[i] = x[i] * (float)(i < n);
}

int launch(const float* x, float* y, int n, cudaStream_t s) {
  scale_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, y, n);
  return 0;
}
"""

FIXTURES = [
    ("step_item", "JL001", {"steps.py": STEP_ITEM},
     {"steps.py": ("loss.item()", "loss.cpu()")}),
    ("dict_carriage", "JL001", {"steps.py": DICT_CARRIAGE},
     {"steps.py": ("float(norm)", "norm.cpu()")}),
    ("tuple_unpack", "JL001", {"steps.py": TUPLE_UNPACK},
     {"steps.py": ("bool(x)", "x.cpu()")}),
    ("arg_flow", "JL001", {"steps.py": ARG_FLOW},
     {"steps.py": ("_read(z, 3)", "_read(batch.shape, 3)")}),
    ("rebind", "JL005", {"steps.py": REBIND},
     {"steps.py": ("if s > 0:", "if s.shape[0] > 0:")}),
    ("partial", "JL001", {"steps.py": PARTIAL},
     {"steps.py": ("int(y)", "y.cpu()")}),
    ("cross_module", "JL001",
     {"impl.py": IMPORTED_IMPL, "builder.py": IMPORTED_BUILDER},
     {"impl.py": ("total.numpy()", "total.cpu()")}),
    ("class_call_step", "JL001", {"steps.py": CLASS_STEP},
     {"steps.py": ("float(loss)", "loss.cpu()")}),
    ("note_fallback", "JL001", {"steps.py": NOTE_FALLBACK},
     {"steps.py": ("int(loss)", "loss.cpu()")}),
    ("tick_path", "JL002", {"server.py": TICK},
     {"server.py": ("int(out[0])", "out.cpu()")}),
    ("checkpoint_capture", "JL003", {"blocks.py": CHECKPOINTED},
     {"blocks.py": ("scales = []\n    def run(h):\n        return h * "
                    "scales[0]\n    scales.append(2.0)",
                    "scales = (2.0,)\n    def run(h):\n        return h * "
                    "scales[0]")}),
    ("autograd_capture", "JL003", {"layers.py": AUTOGRAD_FN},
     {"layers.py": ("history.append(h.shape)\n", "h.shape\n")}),
    ("seed_reuse", "JL004", {"seeds.py": SEED_REUSE},
     {"seeds.py": ("g2.manual_seed(int(key))",
                   "g2.manual_seed(fold_seed(key, 2))")}),
    ("branch", "JL005", {"steps.py": BRANCH},
     {"steps.py": ("torch.any(batch > peak)", "batch.shape[0] > 4")}),
    ("hash_seed", "JL006", {"seeds.py": HASH_SEED},
     {"seeds.py": ("hash(tag)", "zlib.crc32(tag.encode())")}),
    ("escape", "JL007", {"steps.py": ESCAPE},
     {"steps.py": ("LOSSES.append(loss)", "LOSSES.append(loss.detach())")}),
    ("entry_signature", "PK001",
     {"_build.py": SIGNATURES, "entry.cu": ENTRY},
     {"entry.cu": ("const void* x, void* y, int n, void* stream",
                   "const void* x, void* y, int n, int d, void* stream")}),
    ("launch_bounds", "PK002", {"fill.cu": BOUNDS},
     {"fill.cu": ("<<<1, 256, 0, s>>>", "<<<1, 128, 0, s>>>")}),
    ("floor_grid", "PK003", {"tile.cu": FLOOR_GRID},
     {"tile.cu": ("  dim3 grid(n / 64);",
                  "  if (n % 64 != 0) return -3;\n  dim3 grid(n / 64);")}),
    ("shared_budget", "PK004", {"stage.cu": SMEM},
     {"stage.cu": ("kRows = 512", "kRows = 64")}),
    ("macro_ptx", "PK005", {"mma.cuh": MMA_HEADER, "gemm.cu": MMA_KERNEL},
     {"mma.cuh": ('"wgmma.mma_async.sync.aligned.m64n64k16." TY',
                  '"wgmma.mma_async.sync.aligned.m64n64k16.f32." TY')}),
    ("included_helper", "PK006",
     {"pipe.cuh": PIPE_HEADER, "store.cu": PIPE_KERNEL},
     {"store.cu": ("  bulk_commit();\n",
                   "  bulk_commit();\n  bulk_wait<0>();\n")}),
    ("ceil_grid", "PK007", {"copy.cu": CEIL_GRID},
     {"copy.cu": ("  y[i] = x[i];", "  if (i < n) y[i] = x[i];")}),
    ("mask_tail", "PK007", {"scale.cu": MASK_TAIL},
     {"scale.cu": ("x[i] * (float)(i < n)", "(i < n ? x[i] : 0.f)")}),
    ("unbalanced_source", "AN001",
     {"broken.cu": "__global__ void k(float* y) {\n  /* never closed\n}\n"},
     {"broken.cu": ("/* never closed", "// closed")}),
]


def _twin(files, edits):
    out = dict(files)
    for name, (old, new) in edits.items():
        assert old in out[name], (name, old)
        out[name] = out[name].replace(old, new)
    return out


def _run(tmp_path, files):
    return analyze_paths(_write(tmp_path, files), policy=False)


@pytest.mark.parametrize("name,rule,files,edits", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_fires_its_rule_once(tmp_path, name, rule, files, edits):
    findings = _run(tmp_path, files)
    assert [f.rule for f in findings] == [rule], \
        [f.render() for f in findings]


@pytest.mark.parametrize("name,rule,files,edits", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_clean_twin_is_silent(tmp_path, name, rule, files, edits):
    findings = _run(tmp_path, _twin(files, edits))
    assert findings == [], [f.render() for f in findings]


def test_note_fallback_severity_and_tag(tmp_path):
    (f,) = _run(tmp_path, {"steps.py": NOTE_FALLBACK})
    assert f.severity == "note" and "heuristic" in f.message


def test_the_trap_and_an_explicit_read_stay_silent(tmp_path):
    """``int(state["step"])`` of a Python int and a ``.cpu().numpy()``
    read in a class step: only the real sync fires."""
    (f,) = _run(tmp_path, {"steps.py": CLASS_STEP})
    assert "float(loss)" in CLASS_STEP.splitlines()[f.line - 1]


def test_smem_budget_flag(tmp_path, capsys):
    paths = _write(tmp_path, _twin({"stage.cu": SMEM},
                                   {"stage.cu": ("kRows = 512",
                                                 "kRows = 64")}))
    assert main(paths + ["--no-policy"]) == 0
    # 64 rows of 128 floats: 32 KB, over a 16 KB budget
    assert main(paths + ["--no-policy", "--smem-budget-kb", "16"]) == 1
    assert "32768 bytes" in capsys.readouterr().out


# faults of the reference's analyzer that the port's counterparts repair
# (ROADMAP Queue C): (rule, the reference's fixture, the port's)
REFERENCE_FALSE_POSITIVES = [
    # a module's function named like a container method is no store
    ("JL007", """
        import jax
        import optlib

        def make_step(cfg):
            def step(state, batch):
                loss = (state * batch).sum()
                optlib.update(loss)
                return loss
            return step
        """, """
        import torch
        import optlib

        def make_step(cfg):
            def step(state, batch):
                loss = torch.sum(state * batch)
                optlib.update(loss)
                return loss
            return step
        """),
    # a key re-derived between two draws is not reused
    ("JL004", """
        import jax

        def draw(key, shape):
            k = jax.random.fold_in(key, 1)
            a = jax.random.normal(k, shape)
            k = jax.random.fold_in(k, 2)
            b = jax.random.normal(k, shape)
            return a, b
        """, """
        import torch
        from repro_torch.core.seeds import fold_seed

        def draw(seed, device):
            k = fold_seed(seed, 1)
            a = torch.Generator(device=device).manual_seed(k)
            k = fold_seed(k, 2)
            b = torch.Generator(device=device).manual_seed(k)
            return a, b
        """),
]


@pytest.mark.parametrize("rule,ref_src,port_src", REFERENCE_FALSE_POSITIVES,
                         ids=[r for r, _, _ in REFERENCE_FALSE_POSITIVES])
def test_reference_false_positives_the_port_repairs(tmp_path, rule, ref_src,
                                                    port_src):
    (ref,) = _write(tmp_path, {"ref.py": ref_src})
    assert [f.rule for f in ref_analysis.analyze_paths(
        [ref], policy=False)] == [rule]
    os.remove(ref)
    assert _run(tmp_path, {"port.py": port_src}) == []


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

BUILDERS = {
    "steps": """
        import functools
        from helpers import make_pair

        def make_bundle(cfg):
            def step(state, batch):
                return state
            def unused(x):
                return x
            return {"step": step, "name": cfg}

        def make_rebound(cfg):
            def inner(s, b):
                return b
            fn = inner
            return fn

        def make_partial(cfg):
            def body(cfg, s, b):
                return s
            return functools.partial(body, cfg)

        def make_from_pair(cfg):
            step_fn, init_fn = make_pair(cfg)
            return step_fn
        """,
    "helpers": """
        def make_pair(cfg):
            def pstep(s, b):
                return helper(s)
            def pinit(n):
                return n
            return pstep, pinit

        def helper(x):
            return x
        """,
}


def test_step_scopes_equal_the_references_traced_scopes(tmp_path):
    paths = _write(tmp_path, {f"{k}.py": v for k, v in BUILDERS.items()})
    port = dataflow.Program.build([astutil.Module.load(p) for p in paths])
    ref_mods = [ref_astutil.Module.load(p) for p in paths]
    ref = ref_dataflow.Program.build(ref_mods)
    for mod, ref_mod in zip(port.modules, ref_mods):
        got = {mod.symbol_for(f) for f in port.step_functions(mod)}
        want = {ref_mod.symbol_for(f)
                for f in ref.traced_functions(ref_mod)}
        assert got == want
    assert {"make_bundle.step", "make_pair.pstep", "make_pair.pinit",
            "helper"} <= {m.symbol_for(f) for m in port.modules
                          for f in port.step_functions(m)}


@pytest.fixture(scope="module")
def launch_program():
    paths = sorted(os.path.join(LAUNCH, f) for f in os.listdir(LAUNCH)
                   if f.endswith(".py"))
    mods = [astutil.Module.load(p) for p in paths]
    return dataflow.Program.build(mods), mods


def test_engine_holds_the_heuristics_steps_in_launch(launch_program):
    program, mods = launch_program
    for mod in mods:
        ref_mod = ref_astutil.Module.load(mod.path)
        heur = {ref_mod.symbol_for(f) for f in
                ref_jax_lints.traced_functions_heuristic(ref_mod)}
        got = {mod.symbol_for(f) for f in program.step_functions(mod)}
        assert heur <= got, (mod.path, heur - got)
    (ts,) = [m for m in mods if m.path.endswith("train_steps.py")]
    steps = {ts.symbol_for(f) for f in program.step_functions(ts)}
    assert {"ScheduledStepFn.__call__", "make_train_step.train_step"} \
        <= steps


def test_state_step_reads_are_silent_in_launch(launch_program):
    """``step = int(state["step"])`` in both train steps (a Python int)
    and the scheduled step's one explicit ``.cpu()`` read."""
    from repro_torch.analysis import torch_lints
    program, mods = launch_program
    (ts,) = [m for m in mods if m.path.endswith("train_steps.py")]
    lines = ts.source.splitlines()
    reads = [i + 1 for i, ln in enumerate(lines)
             if 'int(state["step"])' in ln or ".cpu().numpy()" in ln]
    assert len(reads) >= 3
    for fn in ts.functions():
        if fn.lineno <= reads[0] <= fn.end_lineno \
                and fn.name == "train_step":
            assert program.is_step(fn)
    found = {(f.path, f.line) for f in torch_lints.check(mods, program)}
    assert not {(ts.path, ln) for ln in reads} & found


# ---------------------------------------------------------------------------
# the C evaluator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kernels():
    return csrc.Program.load([CSRC])


def test_sources_parse(kernels):
    assert kernels.broken == {}
    assert len(kernels.kernels()) == 12


@pytest.mark.parametrize("kernel,targs,threads", [
    ("fused_dw_mma_kernel", ["__nv_bfloat16", 128, 128, 4, 2], 256),
    ("fused_dw_mma_kernel", ["__half", 64, 64, 2, 2], 128),
    # DwLayout<kTile>::kThreads = (kTile / 64 + 2) * 128
    ("fused_dw_wgmma_kernel", ["__nv_bfloat16", 128, 0], 512),
    ("smm_wgmma_kernel", ["__half", 256, 128, 2], 512),
    ("row_norms_kernel", ["float"], 256),
])
def test_launch_bounds_at_an_instance(kernels, kernel, targs, threads):
    fn = kernels.kernel(kernel)
    ev = csrc.Evaluator(kernels, fn.path).bind(fn, targs)
    assert ev.eval(csrc._split_commas(fn.launch_bounds)[0]) == threads


def test_struct_constexpr_and_sizeof(kernels):
    fn = kernels.kernel("fused_dw_wgmma_kernel")
    ev = csrc.Evaluator(kernels, fn.path).bind(fn, ["__half", 64, 1])
    # kAtom 64 * 128, kB = kAtom, kStage 2 kB, kPlan 4 stages, kBars
    # + 16 * 64 * 8 plan bytes, kBytes + 3 * 8 * 4 barriers + 1024
    by_hand = 4 * 2 * 64 * 128 + 16 * 64 * 8 + 3 * 8 * 4 + 1024
    toks = csrc._lex("DwLayout<kTile>::kBytes", "x")
    assert ev.eval(toks) == by_hand == 74848
    for dtype, elems in (("float", 4), ("__nv_bfloat16", 8)):
        ev = csrc.Evaluator(kernels, fn.path, types={"T": dtype})
        assert ev.eval(csrc._lex("Chunk<T>::kElems", "x")) == elems
        assert ev.eval(csrc._lex("16 / (int)sizeof(T)", "x")) == elems


@pytest.mark.parametrize("kernel,dtype,ints,by_hand", [
    # As, Bs: kBK (32) x (BM + 8) of T; stage: 8 warps x 16 x 16 f32
    ("fused_dw_mma_kernel", "bf16", [128, 128, 4, 2],
     2 * 32 * 136 * 2 + 8 * 256 * 4),
    ("fused_dw_mma_kernel", "f16", [64, 64, 2, 2],
     2 * 32 * 72 * 2 + 4 * 256 * 4),
    # As, Bs: kF32BK (16) x kF32Tile (64) f32
    ("sampled_matmul_f32_kernel", None, [], 2 * 16 * 64 * 4),
    ("smm_wgmma_kernel", "bf16", [256, 128, 2], 0),
])
def test_static_smem_bytes_by_hand(kernels, kernel, dtype, ints, by_hand):
    assert csrc.static_smem_bytes(kernels, kernel, dtype, ints) == by_hand


def test_every_launch_resolves_within_the_budget(kernels):
    launches = kernel_contracts.resolve_launches(kernels)
    assert len(launches) >= 40
    for li in launches:
        assert None not in (li.threads, li.bound, li.static, li.dynamic), \
            li.desc
        assert li.threads <= li.bound
        assert li.static + li.dynamic <= \
            kernel_contracts.DEFAULT_SMEM_BUDGET


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_ids_and_severities_are_the_references():
    assert set(RULES) == set(REF_RULES)
    assert {r: RULES[r][0] for r in RULES} == \
        {r: REF_RULES[r][0] for r in REF_RULES}
    assert {rule for _, rule, _, _ in FIXTURES} >= {
        r for r in RULES if r[:2] in ("JL", "PK")}
