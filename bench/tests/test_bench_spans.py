"""``spans.py`` on the CPU: attribution of device operations to the
innermost span on synthetic events (self against inclusive, a span on
autograd's device thread, operations outside every span), the idle gaps
named by span (``read_trace``'s names where there is none), the span
readings of an untraced record, and a traced window of a small cell."""
import pytest
import torch

import harness
import spans
from helpers import BASE_CELL, PREFILL_CELL, reduced_conf, write_cell
from repro_torch import tracing


def span(id, name, a, b, parent=0, thread=1):
    return {"name": name, "id": id, "parent": parent, "caused_by": 0,
            "thread": thread, "start_ns": a, "end_ns": b}


# the caller's train_step ⊃ backward, and on autograd's device thread a
# linear.bwd ⊃ dw, whose parent is the caller's backward
TREE = [span(1, "train_step", 0, 100), span(2, "backward", 10, 90, 1),
        span(3, "linear.bwd", 20, 40, 2, thread=2),
        span(4, "dw", 25, 35, 3, thread=2)]


def test_attribution_innermost_self_and_inclusive():
    # (start, end, name, correlation) on the device, each op d ms long;
    # issued: the runtime call's host start by correlation id
    ms = 1_000_000
    ops = [(0, d * ms, name, corr) for d, name, corr in (
        (5, "k_dw", 11), (3, "k_dx", 12), (2, "k_sum", 13),
        (7, "k_late", 14), (1, "k_lost", 15))]
    issued = {11: 30, 12: 22, 13: 50, 14: 150}
    host = [(30, 38, "cudaLaunchKernel"), (50, 53, "cudaMalloc"),
            (150, 151, "cudaFree")]
    got = spans.attribute(ops, issued, TREE, steps=2, host=host)
    by = got["by_span"]
    assert {n: round(v["self_s"] * 1e3, 9) for n, v in by.items()} == {
        "train_step": 0, "backward": 2, "linear.bwd": 3, "dw": 5}
    assert {n: round(v["device_s"] * 1e3, 9) for n, v in by.items()} == {
        "train_step": 10, "backward": 10, "linear.bwd": 8, "dw": 5}
    assert round(got["unattributed_s"] * 1e3, 9) == 8
    assert round(got["device_s"] * 1e3, 9) == 18
    assert got["ops_in"]["linear.bwd"] == pytest.approx(
        {"k_dw": 0.005, "k_dx": 0.003})
    assert by["dw"]["calls"] == 1 and by["backward"]["host_s"] == 80e-9
    # runtime calls by the span they started in (none outside every span)
    assert got["runtime_in"] == {"dw": {"cudaLaunchKernel": 8e-9},
                                 "backward": {"cudaMalloc": 3e-9}}


def test_innermost_at_the_edges():
    idx = spans.Innermost(TREE + [span(5, "open", 60, None)])
    assert idx.at(None) is None and idx.at(-1) is None
    assert idx.at(0)["name"] == "train_step"
    assert idx.at(20)["name"] == "linear.bwd"
    assert idx.at(35)["name"] == "linear.bwd"     # [start, end)
    assert idx.at(40)["name"] == "backward"
    assert idx.at(100) is None
    assert idx.path(idx.at(30)) == ["train_step", "backward", "linear.bwd",
                                    "dw"]


class _Event:
    def __init__(self, a, b, name, cuda, corr=0):
        self.a, self.b, self.n, self.cuda, self.corr = a, b, name, cuda, corr

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def name(self):
        return self.n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.cuda
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self.corr


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


EVENTS = [_Event(0, 10, "k1", True, 1), _Event(14, 20, "k2", True, 2),
          _Event(50, 60, "k3", True, 3), _Event(0, 12, "cudaLaunchKernel",
                                                False, 1),
          _Event(12, 16, "cudaLaunchKernel", False, 2),
          _Event(21, 45, "cudaMalloc", False),
          _Event(46, 49, "cudaLaunchKernel", False, 3)]
# the window's host clock: 2 ns past the device's last operation
WINDOW_S = 6.2e-8


def test_gaps_without_spans_read_as_read_trace():
    prof = _Prof(EVENTS)
    ops, host, issued = spans.trace_events(prof)
    assert [o[3] for o in ops] == [1, 2, 3] and issued[3] == 46
    want = harness.read_trace(prof, WINDOW_S)["idle_gaps"]
    assert spans.name_gaps([o[:3] for o in ops], host, [], WINDOW_S) == want
    assert [g[0] for g in want][:2] == ["cudaMalloc", "cudaLaunchKernel"]


def test_gaps_carry_the_span_path():
    prof = _Prof(EVENTS)
    ops, host, _ = spans.trace_events(prof)
    named = spans.name_gaps([o[:3] for o in ops], host, TREE, WINDOW_S)
    assert named[0][0] == "cudaMalloc · train_step/backward/linear.bwd"
    assert named[1][0] == "cudaLaunchKernel · train_step/backward"
    plain = harness.read_trace(prof, WINDOW_S)["idle_gaps"]
    assert [g[1] for g in named] == [g[1] for g in plain]


def test_readings_are_none_on_an_untraced_record():
    for mode in ("train", "prefill"):
        rec = {"mode": mode, "steps": 3, "window_s": 1.0}
        assert set(spans.readings(rec).values()) == {None}


def test_readings_of_a_record():
    by = {"attention": 0.3, "attention.bwd": 0.6, "optimizer": 0.12,
          "plan": 0.015, "block": 0.9}
    sp = {"steps": 3, "device_s": 3.0, "unattributed_s": 0.0,
          "by_span": {n: {"calls": 3, "host_s": 0.1, "device_s": s,
                          "self_s": s / 3} for n, s in by.items()},
          "ops_in": {}, "runtime_in": {},
          "forward_bytes": [3 << 30, 1 << 30, 2 << 30],
          "counters": {"tile_sources": {"pinned": 0, "table": 1,
                                        "rule": 3}}}
    train = spans.readings({"mode": "train", "spans": sp})
    assert train == pytest.approx({
        "attention_ms.train": 300.0, "optimizer_ms.train": 40.0,
        "plan_ms.train": 5.0, "block_self_ms.prefill": None,
        "saved_gib.train": 2.0, "dw_table_share.train": 25.0})
    prefill = spans.readings({"mode": "prefill", "spans": sp})
    assert prefill["block_self_ms.prefill"] == pytest.approx(100.0)
    assert prefill["attention_ms.train"] is None
    line = spans.spans_line(sp)
    assert line.startswith("spans: 3 steps") and "unattributed 0.0 %" in line


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_a_traced_window_on_the_cpu(tmp_path, mode):
    conf = reduced_conf("nemotron-4-15b")
    base = BASE_CELL if mode == "train" else PREFILL_CELL
    cell = write_cell(tmp_path, "c", "nemotron-4-15b", conf, **base)
    harness.set_cache_dirs()
    rec = spans.traced(harness.Context(cell, 2 ** 31 + 11, "cpu"), 0.1)
    assert not tracing.enabled()
    root = "train_step" if mode == "train" else "prefill_step"
    assert rec["spans"]["by_span"][root]["calls"] == rec["steps"] >= 1
    # no device on the CPU: nothing to attribute, and no reading from it
    assert rec["spans"]["device_s"] == 0.0
    assert spans.readings(rec)["saved_gib.train"] is None
