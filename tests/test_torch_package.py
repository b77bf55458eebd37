"""Package-level rules of the port: it imports neither jax nor the JAX
package, never falls back from the card to the CPU, and its kernel
wrappers refuse what the kernels do not take."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import policy as jax_policy
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro_torch import convert
from repro_torch.api import Run, RunSpec
from repro_torch.core import (KernelConfig, WTACRSConfig, init_lora_params,
                              policy)
from repro_torch.kernels import _build, ops
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models.registry import get_config
from repro_torch.serve import ServeSpec, pool

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_of_the_port_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_importing_the_whole_port_loads_neither_jax_nor_repro():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT_FILES[:-1])
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "print(len(sys.modules))\n")
    done = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert done.returncode == 0, done.stderr
    assert len(mods) >= 25


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert '"ok"' not in done.stdout


SERVE_ENTRIES = ["make_prefill_step", "make_serve_step",
                 "make_prefill_chunk_step", "make_slot_serve_step",
                 "make_slot_prefill_step", "make_slot_reset_step",
                 "decode_state_init", "init_pool", "ServeSpec"]


@pytest.mark.parametrize("entry", ["init_params", "init_train_state",
                                   "make_train_step",
                                   "make_scheduled_train_step",
                                   "params_from_jax", "cache_from_jax",
                                   "Run", "Run.resume", "init_lora_params"]
                         + SERVE_ENTRIES)
def test_device_cuda_raises_instead_of_falling_back(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    cfg = get_config("qwen2.5-3b", reduced=True)
    p = cm.Policy()
    calls = {
        "init_params": lambda: lm.init_params(cfg, 0),
        "init_train_state": lambda: train_steps.init_train_state(cfg, 0),
        "make_train_step": lambda: train_steps.make_train_step(
            cfg, None, train_steps.optim.AdamWConfig(), lambda s: 1e-3),
        "make_scheduled_train_step": lambda:
            train_steps.make_scheduled_train_step(
                cfg, p, train_steps.optim.AdamWConfig(), lambda s: 1e-3),
        "params_from_jax": lambda: convert.params_from_jax(cfg, {}),
        "cache_from_jax": lambda: convert.cache_from_jax({}),
        "make_prefill_step": lambda: train_steps.make_prefill_step(cfg, p),
        "make_serve_step": lambda: train_steps.make_serve_step(cfg, p),
        "make_prefill_chunk_step": lambda:
            train_steps.make_prefill_chunk_step(cfg, p, 4),
        "make_slot_serve_step": lambda:
            train_steps.make_slot_serve_step(cfg, p),
        "make_slot_prefill_step": lambda:
            train_steps.make_slot_prefill_step(cfg, p, 4, True),
        "make_slot_reset_step": lambda: train_steps.make_slot_reset_step(cfg),
        "decode_state_init": lambda: lm.decode_state_init(cfg, 2, 8),
        "init_pool": lambda: pool.init_pool(
            cfg, ServeSpec(arch="qwen2.5-3b", device="cpu")),
        "ServeSpec": lambda: ServeSpec(arch="qwen2.5-3b"),
        "Run": lambda: Run(RunSpec(arch="qwen2.5-3b")),
        "Run.resume": lambda: Run.resume(RunSpec(arch="qwen2.5-3b")),
        "init_lora_params": lambda: init_lora_params(0, 8, 8, 2),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()          # the default device is "cuda"


def _dw_args():
    return [torch.zeros(2, 4, 8), torch.zeros(2, 6, 8),
            torch.zeros(2, 4, dtype=torch.int32), torch.ones(2, 4)]


@pytest.mark.parametrize("which,change,error", [
    (1, lambda t: t.to(torch.bfloat16), TypeError),          # dz dtype
    (2, lambda t: t.to(torch.int64), TypeError),             # idx dtype
    (3, lambda t: t.to(torch.float64), TypeError),           # scale dtype
    (0, lambda t: t.to(torch.float64), TypeError),           # hsub dtype
    (0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),                                            # strides
    (1, lambda t: t[:, :, ::2].repeat(1, 1, 2)[:, ::2], ValueError),
    (2, lambda t: t[:, :3], ValueError),                     # plan shape
    (1, lambda t: t[0], ValueError),                         # rank
])
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(which, change,
                                                             error):
    args = _dw_args()
    args[which] = change(args[which])
    with pytest.raises(error):
        ops.fused_sampled_dw(*args)


def test_fused_wrapper_refuses_unknown_tile():
    with pytest.raises(ValueError, match="tile"):
        ops.fused_sampled_dw(*_dw_args(), tile=32)
    with pytest.raises(ValueError, match="dw_tile"):
        KernelConfig(dw_tile=32)
    assert WTACRSConfig().with_kernel(KernelConfig(dw_tile=64)
                                      ).kernel.dw_tile == 64


@pytest.mark.parametrize("x,error", [
    (torch.zeros(4, 4, dtype=torch.float64), TypeError),
    (torch.zeros(4, 4, dtype=torch.int32), TypeError),
    (torch.zeros(4, 8)[:, ::2], ValueError),
    (torch.zeros(4), ValueError),
    (torch.zeros(0, 4), ValueError),
])
def test_row_norms_wrapper_refuses_what_the_kernel_does_not_take(x, error):
    with pytest.raises(error):
        ops.row_norms(x)


def test_kernel_sources_are_packaged_and_hashed():
    names = sorted(p.name for p in _build.CSRC.iterdir())
    assert names == ["common.cuh", "flash_attention_fwd.cu",
                     "fused_sampled_dw.cu", "gather_scale.cu", "hopper.cuh",
                     "row_norms.cu", "sampled_matmul.cu"]
    assert set(_build._SIGNATURES) == {"repro_row_norms",
                                       "repro_gather_scale",
                                       "repro_sampled_matmul",
                                       "repro_fused_sampled_dw",
                                       "repro_flash_attention_fwd"}
    assert set(ops.__all__) == {"row_norms", "gather_scale",
                                "sampled_matmul", "fused_sampled_dw",
                                "flash_attention_fwd"}
    for name in _build._SIGNATURES:
        assert any(f'extern "C" int {name}(' in p.read_text()
                   for p in _build.CSRC.glob("*.cu"))
    assert len(_build._source_hash()) == 16
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert ('"repro_torch.kernels" = ["csrc/*.cu", "csrc/*.cuh", '
            '"tuning_table.json"]') in pyproject
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored and "*.so" in ignored


def test_policy_rules_resolve_exactly_like_the_reference():
    def build(mod, cfg_cls):
        return mod.PolicyRules.of(
            ("*attn_o", cfg_cls(kind="exact", budget=1.0)),
            ("*mlp_*", cfg_cls(kind="wta_crs", budget=0.1),
             mod.BudgetSchedule.warmup_exact(begin_step=5, end=0.1)),
            ("b1/*", {"budget": 0.5},
             mod.BudgetSchedule.linear(1.0, 0.2, 2, 10, stages=4)))

    jr, tr = build(jax_policy, JaxWTACRSConfig), build(policy, WTACRSConfig)
    fb_j, fb_t = JaxWTACRSConfig(budget=0.3), WTACRSConfig(budget=0.3)
    for tag in ("b0/attn_o", "b0/mlp_wi", "b1/attn_q", "b0/attn_q"):
        for step in (0, 3, 5, 7, 12):
            a = jr.resolve(tag, step=step, fallback=fb_j)
            b = tr.resolve(tag, step=step, fallback=fb_t)
            assert (a.kind_name, a.budget, a.min_rows, a.norm_source.value) \
                == (b.kind_name, b.budget, b.min_rows, b.norm_source.value)
            assert a.budget_rows(100) == b.budget_rows(100)
    for step in (0, 4, 9, 20):
        assert jr.schedule_signature(step, fallback=fb_j) \
            == tr.schedule_signature(step, fallback=fb_t)
    np.testing.assert_equal(jr.dynamic_rule_indices(),
                            tr.dynamic_rule_indices())
