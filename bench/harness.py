"""The benchmark's engine: one cell, one seed, one run.

It reads ``BENCHMARK.json``, the cell's file (``cells/<cell>.json``) and
its configuration's (``configs/<config>.json``), drives the cell's mode
(``modes/<mode>.py``), times the window, reads the profiler's trace in a
traced run, and hands the run's record to each metric's reader
(``metrics/<metric>.py``).  A later cell, configuration or metric is a
new file and a new entry; nothing here names one.

The window: the mode's steps issued back to back from the first timed
step until ``--seconds`` have passed on the host clock, then one
synchronise, where the window ends.  Set-up (process start to the first
timed step) covers building or loading the kernels, the weights and
batches made on the card, and the mode's first steps, which warm every
shape the window uses.  After the window, with the peak read, the mode
frees the program's state and runs the plain reference (``check.py``
decides ``correct``).
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start, in seconds since the epoch (from /proc);
    the import time of this module where /proc is not there."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file (names here may hold '.' and '-')."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def metrics_for(spec: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run), in ``BENCHMARK.json``'s order."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key] if applies(m, cell)]


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """A cell's files, found by name: its cell and configuration files
    under ``data`` (the benchmark's own by default), its mode's driver."""

    def __init__(self, name: str, data: Path = BENCH):
        self.name = name
        self.spec = load_json(data / "cells" / f"{name}.json")
        self.conf = load_json(data / "configs" / f"{self.spec['config']}.json")
        self.mode = load_module(BENCH / "modes" / f"{self.spec['mode']}.py",
                                f"bench_mode_{self.spec['mode']}")


def arch_config(conf: Dict):
    """The program's ``ArchConfig`` of this configuration file: its arch
    with every field the file states."""
    import dataclasses

    from repro_torch.configs import get_config
    base = get_config(conf["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    given = {k: (tuple(v) if isinstance(v, list) else v)
             for k, v in conf.items() if k in fields}
    return dataclasses.replace(base, **given)


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def read_trace(prof, window_s: float) -> Dict:
    """From the profiler's raw events, which hold the window's work and
    nothing else (set-up synchronised before the profiler started, the
    window's synchronise returned before it stopped): the union of the
    device's operations (kernels, copies, sets), the device seconds by
    operation name, and the longest idle gaps, each named by the
    innermost host event (on the card, a CUDA runtime call) running at
    its middle.  The window's length is the host clock's; what the
    device's span of operations leaves of it (the first launch and the
    synchronise's return) is one more gap."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((a, b, e.name()))
        else:
            host.append((a, b, e.name()))
    by_name: Dict[str, float] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    merged = _union([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged) / 1e9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        over = [(b - a, n) for a, b, n in host if a <= mid < b]
        named.append([min(over)[1][:120] if over else "host: no operation",
                      length / 1e9])
    if merged:
        named.append(["window edges: the first launch and the "
                      "synchronise's return",
                      window_s - (merged[-1][1] - merged[0][0]) / 1e9])
    named = sorted(named, key=lambda g: -g[1])[:10]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy,
            "kernel_s": by_name,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": named}


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

class Context:
    """What a mode's driver is handed: the cell, the seed, the device and
    the fault planted for a check of the check (None in a run)."""

    def __init__(self, cell: Cell, seed: int, device: str,
                 fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = (cell, seed, device,
                                                         fault)
        self.spec, self.conf = cell.spec, cell.conf


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


# allocator counters read over the window: a retry frees every cached
# block and synchronises; a device alloc or free is a cudaMalloc / cudaFree
ALLOC_STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def window_record(marks, window_s: float, before: Dict, after: Dict
                  ) -> Dict:
    """What the window's per-step events say, beside its rate: the device
    seconds of each step (event to event: a step's work and any wait for
    the host before it), the slowest step and how far ahead of its start
    the host had issued it, what the host clock holds past the device's
    last step (the synchronise's return), and the allocator's counters."""
    t = [m[1] for m in marks]
    first, ends = t[0], t[1:]
    span = first.elapsed_time(ends[-1]) / 1e3
    done = [first.elapsed_time(e) / 1e3 for e in ends]
    per_step = [b - a for a, b in zip([0.0] + done[:-1], done)]
    slow = max(range(len(per_step)), key=per_step.__getitem__)
    # marks[i + 1] was taken once step i was issued
    issued = marks[slow + 1][0]
    started = done[slow - 1] if slow else 0.0
    return {"step_device_s": per_step, "slowest_step": slow,
            "issued_ahead_s": started - issued,
            "sync_lag_s": window_s - span,
            "alloc": {k: after.get(k, 0) - before.get(k, 0)
                      for k in ALLOC_STATS}}


def window_line(w: Dict) -> str:
    import statistics
    steps = w["step_device_s"]
    return (f"window: {len(steps)} steps, device s a step median "
            f"{statistics.median(steps)!r} max {max(steps)!r} (step "
            f"{w['slowest_step']}, issued {w['issued_ahead_s']!r} s before "
            f"its start); host clock past the last step {w['sync_lag_s']!r}"
            f" s; allocator {w['alloc']}")


def measure(ctx: Context, seconds: float, trace: bool, start: float) -> Dict:
    """Set-up, the window, the peak, then the check.  Returns the run's
    record.  A traced run records the card's activity alone (kernels,
    copies, sets and the CUDA runtime's calls), not the host's
    operations, so the host paces the window as it does untraced."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    drv = ctx.cell.mode.Driver(ctx)
    drv.setup()
    sync(ctx.device)
    on_card = ctx.device == "cuda"
    resident = torch.cuda.memory_allocated() if on_card else 0
    stats0 = torch.cuda.memory_stats() if on_card else {}
    acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]

    def mark(t):
        if not on_card:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return (t, ev)

    with (profile(activities=acts) if trace
          else contextlib.nullcontext()) as prof:
        t_first = time.time()
        t0 = time.perf_counter()
        marks = [mark(0.0)]
        steps = 0
        while True:
            drv.step(steps)
            steps += 1
            t = time.perf_counter() - t0
            marks.append(mark(t))
            if t >= seconds:
                break
        sync(ctx.device)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    rec = {"steps": steps, "window_s": window_s,
           "setup_s": t_first - start, "peak_bytes": peak,
           "resident_bytes": resident, **drv.work()}
    lines = []
    if on_card:
        rec["window"] = window_record(marks, window_s, stats0,
                                      torch.cuda.memory_stats())
        lines.append(window_line(rec["window"]))
    if trace:
        rec["trace"] = read_trace(prof, window_s)
    t_check = time.perf_counter()
    rec.update(drv.check())
    rec["check_lines"] = lines + rec["check_lines"] + [
        f"check took {time.perf_counter() - t_check:.1f} s"]
    return rec


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def result(cell: Cell, rec: Dict, trace: bool, spec: Dict,
           device: Dict) -> Dict:
    """The result line: every metric of the cell whose reader found
    something to read, the device, the breakdown, the checks last."""
    metrics = {}
    for m in metrics_for(spec, cell.name, trace):
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace:
        out["device"]["busy_s"] = rec["trace"]["busy_s"]
        out["device"]["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = rec["checks"]
    return out
