"""Where a traced window's device time went, by the program's own spans.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--out <file.json>]

from the root of a checkout, on a machine with the card the cell asks
for.  It runs the cell as ``bench/run.py --trace 1`` does (set-up, one
synchronise, a window of ``--seconds`` under the profiler recording the
card's activity and the CUDA runtime's calls), with the program's span
recorder (``repro_torch.tracing``) on over the window, and no check.
Standard error gets the ``window:`` line, then a ``spans:`` line (per
span name a step: calls, host ms, device ms inclusive and self; the
device time launched outside every span; the kernels' launches by
route), the idle gaps named by the span open at their middle, and the
cross-checks against the kernel-name readers; the last line of standard
output is a JSON object of the span readings (``readings``).

Attribution: each device operation (kernel, copy, set) of the trace maps
through its correlation id to the runtime call that issued it, and that
call's host start to the innermost span open then, on any thread (one
thread at a time issues the program's work: the caller, or autograd's
device thread inside the caller's ``backward``).  A span's inclusive
device time holds every operation attributed to it or to a span below
it; its self time, those attributed to it alone.
"""
from __future__ import annotations

import argparse
import bisect
import heapq
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402

# (start_ns, end_ns, name, correlation id)
Op = Tuple[int, int, str, int]


class Innermost:
    """The innermost span open at a host instant: of the spans whose
    [start, end) holds it, the one that started last."""

    def __init__(self, spans: Sequence[Dict]):
        closed = [s for s in spans if s["end_ns"] is not None]
        self.by_id = {s["id"]: s for s in spans}
        self.marks = sorted({s["start_ns"] for s in closed}
                            | {s["end_ns"] for s in closed})
        self.inner: List[Optional[Dict]] = []
        order = sorted(closed, key=lambda s: s["start_ns"])
        heap: List = []
        i = 0
        for m in self.marks:
            while i < len(order) and order[i]["start_ns"] <= m:
                s = order[i]
                heapq.heappush(heap, (-s["start_ns"], -s["id"],
                                      s["end_ns"], s["id"]))
                i += 1
            while heap and heap[0][2] <= m:
                heapq.heappop(heap)
            self.inner.append(self.by_id[heap[0][3]] if heap else None)

    def at(self, t: Optional[int]) -> Optional[Dict]:
        if t is None:
            return None
        j = bisect.bisect_right(self.marks, t) - 1
        return self.inner[j] if j >= 0 else None

    def path(self, span: Dict) -> List[str]:
        """Span names from the root down to ``span``."""
        out = []
        while span is not None:
            out.append(span["name"])
            span = self.by_id.get(span["parent"])
        return out[::-1]


def attribute(ops: Sequence[Op], issued: Dict[int, int],
              spans: Sequence[Dict], steps: int,
              host: Sequence[Tuple[int, int, str]] = ()) -> Dict:
    """Device seconds by span name (inclusive and self), and by operation
    name inside each span name; host seconds and calls by span name;
    the device seconds of operations issued outside every span or whose
    runtime call is missing (``unattributed_s``); the host seconds of the
    runtime calls (``host``: (start, end, name)) by the span name they
    started in.  ``issued``: a runtime call's host start by correlation
    id."""
    idx = Innermost(spans)
    incl: Dict[str, float] = defaultdict(float)
    own: Dict[str, float] = defaultdict(float)
    ops_in: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    paths: Dict[int, frozenset] = {}
    total = unattributed = 0.0
    for a, b, name, corr in ops:
        d = (b - a) / 1e9
        total += d
        s = idx.at(issued.get(corr))
        if s is None:
            unattributed += d
            continue
        own[s["name"]] += d
        if s["id"] not in paths:
            paths[s["id"]] = frozenset(idx.path(s))
        for n in paths[s["id"]]:
            incl[n] += d
            ops_in[n][name] += d
    runtime: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for a, b, name in host:
        s = idx.at(a)
        if s is not None:
            runtime[s["name"]][name] += (b - a) / 1e9
    host_s: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    for s in spans:
        calls[s["name"]] += 1
        if s["end_ns"] is not None:
            host_s[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e9
    return {"steps": steps, "device_s": total,
            "unattributed_s": unattributed,
            "by_span": {n: {"calls": calls[n], "host_s": host_s[n],
                            "device_s": incl.get(n, 0.0),
                            "self_s": own.get(n, 0.0)} for n in calls},
            "ops_in": {n: dict(v) for n, v in ops_in.items()},
            "runtime_in": {n: dict(v) for n, v in runtime.items()}}


def name_gaps(dev: Sequence[Tuple[int, int, str]],
              host: Sequence[Tuple[int, int, str]], spans: Sequence[Dict],
              window_s: float) -> List[list]:
    """``harness.read_trace``'s idle gaps, each name followed by
    `` · <span path>`` of the innermost span open at the gap's middle
    (nothing where none is open: with no spans, the names are
    ``read_trace``'s)."""
    idx = Innermost(spans)
    merged = harness._union([(a, b) for a, b, _ in dev])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        over = [(b - a, n) for a, b, n in host if a <= mid < b]
        name = min(over)[1][:120] if over else "host: no operation"
        s = idx.at(int(mid))
        if s is not None:
            name += " · " + "/".join(idx.path(s))
        named.append([name, length / 1e9])
    if merged:
        named.append(["window edges: the first launch and the "
                      "synchronise's return",
                      window_s - (merged[-1][1] - merged[0][0]) / 1e9])
    return sorted(named, key=lambda g: -g[1])[:10]


def trace_events(prof):
    """(device operations as ``Op``, host events as (start, end, name),
    runtime call start by correlation id) of a profiler's raw events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, host, issued = [], [], {}
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                ops.append((a, b, e.name(), e.correlation_id()))
        else:
            host.append((a, b, e.name()))
            if e.correlation_id() > 0:
                issued[e.correlation_id()] = a
    return ops, host, issued


def counters() -> Dict:
    """The kernels' launch counters and the tile sources, as they are."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import ops as kernel_ops
    out = {"tile_sources": dict(autotune.resolve_blocks.tile_sources)}
    for name in kernel_ops.__all__:
        fn = getattr(kernel_ops, name)
        out[name] = dict(getattr(fn, "launches_by_route",
                                 {"all": fn.launches}))
    return out


def _delta(before: Dict, after: Dict) -> Dict:
    return {k: {r: after[k][r] - before[k].get(r, 0) for r in after[k]
                if after[k][r] - before[k].get(r, 0)}
            for k in after}


def summarize(ops, host, issued, spans, steps, before, after) -> Dict:
    out = attribute(ops, issued, spans, steps, host)
    out["counters"] = _delta(before, after)
    forward = [s["mem_end"] - s["mem_start"] for s in spans
               if s["name"] == "forward" and "mem_end" in s]
    out["forward_bytes"] = forward
    return out


def readings(rec: Dict) -> Dict[str, Optional[float]]:
    """The span readings of a run's record (each None where the run has
    nothing to read: no spans, another mode, no such span)."""
    names = ("attention_ms.train", "optimizer_ms.train", "plan_ms.train",
             "block_self_ms.prefill", "saved_gib.train",
             "dw_table_share.train")
    out: Dict[str, Optional[float]] = dict.fromkeys(names)
    sp = rec.get("spans")
    if not sp or not sp["steps"]:
        return out
    by, steps = sp["by_span"], sp["steps"]

    def ms(name, key="device_s"):
        return 1e3 * by[name][key] / steps if name in by else None

    if rec.get("mode") == "train":
        att = [by[n]["device_s"] for n in ("attention", "attention.bwd")
               if n in by]
        out["attention_ms.train"] = 1e3 * sum(att) / steps if att else None
        out["optimizer_ms.train"] = ms("optimizer")
        out["plan_ms.train"] = ms("plan")
        if sp["forward_bytes"]:
            out["saved_gib.train"] = statistics.median(
                sp["forward_bytes"]) / 2 ** 30
        tiles = sp["counters"].get("tile_sources", {})
        if sum(tiles.values()):
            out["dw_table_share.train"] = (100.0 * tiles.get("table", 0)
                                           / sum(tiles.values()))
    elif rec.get("mode") == "prefill":
        out["block_self_ms.prefill"] = ms("block", "self_s")
    return out


def spans_line(sp: Dict) -> str:
    steps = max(sp["steps"], 1)
    parts = []
    for n, v in sorted(sp["by_span"].items(), key=lambda kv:
                       -kv[1]["device_s"]):
        parts.append(f"{n} {v['calls'] / steps:g}x host "
                     f"{1e3 * v['host_s'] / steps:.3f} device "
                     f"{1e3 * v['device_s'] / steps:.3f} self "
                     f"{1e3 * v['self_s'] / steps:.3f}")
    share = 100.0 * sp["unattributed_s"] / max(sp["device_s"], 1e-30)
    launches = {k: {r: n / steps for r, n in v.items()}
                for k, v in sp["counters"].items() if v}
    return (f"spans: {sp['steps']} steps, ms a step; " + "; ".join(parts)
            + f"; unattributed {share!r} % of {sp['device_s']!r} device-s"
            + f"; launches a step {launches}")


def traced(ctx, seconds: float) -> Dict:
    """The cell's set-up, then one traced window with the recorder on:
    the record ``harness.measure`` makes, without the check, plus the
    span attribution (``spans``) and the named gaps.  Off the card (the
    tests) the profiler records the host, and no device operation is
    attributed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    drv = ctx.cell.mode.Driver(ctx)
    drv.setup()
    harness.sync(ctx.device)
    on_card = ctx.device == "cuda"
    stats0 = torch.cuda.memory_stats() if on_card else {}
    before = counters()
    tracing.drain()
    tracing.enable()

    def mark(t):
        if not on_card:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return (t, ev)

    acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
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
        harness.sync(ctx.device)
        window_s = time.perf_counter() - t0
    tracing.disable()
    spans = tracing.drain()
    rec = {"steps": steps, "window_s": window_s, **drv.work(),
           "trace": harness.read_trace(prof, window_s)}
    if on_card:
        rec["window"] = harness.window_record(marks, window_s, stats0,
                                              torch.cuda.memory_stats())
    ops, host, issued = trace_events(prof)
    rec["spans"] = summarize(ops, host, issued, spans, steps, before,
                             counters())
    rec["idle_gaps"] = name_gaps([o[:3] for o in ops], host, spans,
                                 window_s)
    return rec


def checks(rec: Dict) -> List[str]:
    """The span attribution against what the kernel-name readers and the
    ``window:`` line see in the same window."""
    import re
    sp, kernel_s = rec["spans"], rec["trace"]["kernel_s"]
    lines = []

    def named(pattern, inside=None):
        rx = re.compile(pattern)
        pool = kernel_s if inside is None else sp["ops_in"].get(inside, {})
        return sum(s for n, s in pool.items() if rx.search(n))

    dw = r"\bfused_dw_\w*kernel"
    flash = r"\bflash_fwd_\w*kernel"
    dw_spans = sp["by_span"].get("dw", {}).get("device_s", 0.0)
    lines.append(f"check: device s in dw spans {dw_spans!r}, fused_dw_* "
                 f"kernels {named(dw)!r} (of them in dw spans "
                 f"{named(dw, 'dw')!r})")
    lines.append(f"check: flash_fwd_* kernels {named(flash)!r}, of them "
                 f"in attention spans {named(flash, 'attention')!r}")
    by, steps = sp["by_span"], max(sp["steps"], 1)

    def per_step(*names):
        return sum(by.get(n, {}).get("device_s", 0.0) for n in names) / steps

    for n in sorted(sp["runtime_in"], key=lambda n: -by[n]["host_s"])[:4]:
        top = sorted(sp["runtime_in"][n].items(), key=lambda kv: -kv[1])
        lines.append(f"host: {n} {1e3 * by[n]['host_s'] / steps:.3f} ms a "
                     f"step, of it in runtime calls " + ", ".join(
                         f"{c} {1e3 * t / steps:.3f}" for c, t in top[:3]))
    median = statistics.median(rec["window"]["step_device_s"])
    lines.append(f"check: device s a step in forward + backward + "
                 f"optimizer {per_step('forward', 'backward', 'optimizer')!r}"
                 f", in prefill_step {per_step('prefill_step')!r}; the "
                 f"window's median step {median!r}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="write the whole record here as JSON")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        print("no card: spans.py reads a CUDA trace", file=sys.stderr)
        return 2
    rec = traced(harness.Context(cell, args.seed, "cuda"), args.seconds)
    for line in ([harness.window_line(rec["window"]),
                  spans_line(rec["spans"]),
                  f"idle gaps: {rec['idle_gaps']}"] + checks(rec)):
        print(line, file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {k: v for k, v in rec.items() if k != "trace"}
            | {"device_ops": rec["trace"]["device_ops"],
               "busy_s": rec["trace"]["busy_s"],
               "device": harness.power_limit()}))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **readings(rec)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
