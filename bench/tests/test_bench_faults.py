"""A whole run (set-up, window, check) on the CPU with the timed path
broken underneath: ``correct`` comes out false for every fault the cell
can have, and true without one.  (One chip: no exchange between chips to
leave out.)"""
import pytest

import faults
from helpers import BASE_CELL, PREFILL_CELL, reduced_conf, run, write_cell


@pytest.fixture(autouse=True)
def _restore():
    yield
    faults.unplant()


def _cell(tmp_path, mode):
    conf = reduced_conf("nemotron-4-15b")
    if mode == "train":
        return write_cell(tmp_path, "t", "nemotron-4-15b", conf, **BASE_CELL)
    return write_cell(tmp_path, "p", "nemotron-4-15b", conf, **PREFILL_CELL)


@pytest.mark.parametrize("mode,fault", [(m, f) for m in faults.FAULTS
                                        for f in faults.FAULTS[m]])
def test_fault_is_not_correct(tmp_path, mode, fault):
    rec = run(_cell(tmp_path, mode), fault=fault)
    assert not rec["correct"], rec["numbers"]


@pytest.mark.parametrize("mode", sorted(faults.FAULTS))
def test_sound_run_is_correct(tmp_path, mode):
    rec = run(_cell(tmp_path, mode))
    assert rec["correct"], rec["numbers"]


def test_traced_run_gives_its_line(tmp_path):
    """A traced run on the CPU: the window's span is found and the result
    line is built (no device operation there, so no roofline)."""
    import harness
    cell = _cell(tmp_path, "train")
    rec = run(cell, trace=True)
    spec = {"end_to_end": [], "per_layer": [
        {"name": "mfu.train", "unit": "%"},
        {"name": "dw_roofline.train", "unit": "%"},
        {"name": "working_set_gib", "unit": "GiB"}]}
    line = harness.result(cell, rec, True, spec, {"platform": "cpu"})
    assert rec["trace"]["window_s"] > 0 and rec["trace"]["busy_s"] == 0
    assert "dw_roofline.train" not in line["metrics"]
    assert "mfu.train" in line["metrics"]
    assert list(line)[-1] == "checks" and line["correct"]
